// Grid-overhead probe for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of scripts/grid_overhead.py (`run_variant`,
// `run_full_shape`, `run_img_revisit`): they measure the fixed cost of the
// megakernel's grid (160 steps of a (184, 256) f32 output block) as input
// blocks are added.  Here one kernel takes every variant: 160 blocks of 256
// threads, each writing its (184, 256) block of zeros, and reading
//   * the 256 columns of each bound lane input (up to 7, r rows each);
//   * its entry iog[g] of the image-index array, always bound (the TPU
//     variants all bind it as scalar prefetch);
//   * with an image stack bound, the whole (H, W) f32 image iog[g];
//   * with the full harness, cnt[g] and its code_len / ng entries of code.
// On the TPU a BlockSpec stages its block whether the body reads it or not;
// on the card an unread pointer moves no bytes.  So every block sums what
// it read into checksum[g], which the plain version recomputes.  The TPU's
// 4 MiB VMEM scratch does not fit a block: the "scratch" variant asks for
// the most dynamic shared memory a block may take instead (232,448 B less
// the kernel's own 32: one block per SM), whose cost is the lost
// occupancy.
//
// What bounds it: bytes.  The output is 30.1 MB; the 7 lane inputs add
// 39.0 MB; each distinct image read adds 1.72 MB from device memory, and a
// revisited one comes from the 50 MB L2.  The image loop keeps 8 16-byte
// loads in flight per thread, so a block streaming its image is not bound
// by one load chain's latency.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int GROUP = 256;
constexpr int OUT_ROWS = 184;
constexpr int MAX_LANES = 7;
constexpr int UNROLL = 8;

struct Lanes {
  const float* ptr[MAX_LANES];
  int rows[MAX_LANES];
};

__device__ __forceinline__ float sum4(float4 v) {
  return (v.x + v.y) + (v.z + v.w);
}

__global__ void __launch_bounds__(GROUP)
grid_overhead_kernel(Lanes lanes, int n_lanes, const int* __restrict__ iog,
                     const float* __restrict__ images, size_t img_elems,
                     const int* __restrict__ cnt,
                     const int* __restrict__ code, int code_per_block,
                     float* __restrict__ out, float* __restrict__ checksum) {
  __shared__ float warp_sums[GROUP / 32];
  const int g = blockIdx.x;
  const int t = threadIdx.x;
  const size_t ncols = (size_t)gridDim.x * GROUP;
  const size_t col = (size_t)g * GROUP + t;

#pragma unroll 8
  for (int row = 0; row < OUT_ROWS; ++row) out[row * ncols + col] = 0.0f;

  const int img = iog[g];
  float acc = 0.0f;
  for (int i = 0; i < n_lanes; ++i) {
    const float* p = lanes.ptr[i];
    for (int r = 0; r < lanes.rows[i]; ++r) acc += p[r * ncols + col];
  }
  if (images != nullptr) {
    // img_elems is a multiple of 4 and each image 16-byte aligned
    const float4* im = reinterpret_cast<const float4*>(images +
                                                       (size_t)img * img_elems);
    const int n4 = (int)(img_elems / 4);
    float part[UNROLL] = {};
    int i = t;
    for (; i + (UNROLL - 1) * GROUP < n4; i += UNROLL * GROUP) {
      float4 v[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) v[u] = __ldg(im + i + u * GROUP);
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) part[u] += sum4(v[u]);
    }
    for (; i < n4; i += GROUP) part[0] += sum4(__ldg(im + i));
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) acc += part[u];
  }
  if (cnt != nullptr) {
    const int* c = code + (size_t)g * code_per_block;
    for (int i = t; i < code_per_block; i += GROUP) acc += (float)c[i];
    if (t == 0) acc += (float)cnt[g];
  }
  if (t == 0) acc += (float)img;

  // block sum of acc
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  if ((t & 31) == 0) warp_sums[t >> 5] = acc;
  __syncthreads();
  if (t == 0) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < GROUP / 32; ++w) s += warp_sums[w];
    checksum[g] = s;
  }
}

}  // namespace

// The most dynamic shared memory one block of the probe may take on the
// current device (its opt-in limit less the kernel's static shared memory),
// or -1 on error.
extern "C" int grid_overhead_max_smem() {
  int dev = 0, optin = 0;
  cudaFuncAttributes attr;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess ||
      cudaFuncGetAttributes(&attr, grid_overhead_kernel) != cudaSuccess) {
    return -1;
  }
  return optin - (int)attr.sharedSizeBytes;
}

// Launches the probe on `stream` (a cudaStream_t passed as a pointer): `ng`
// blocks, out (184, ng * 256) f32 zeros, checksum (ng,) f32.  `lanes` holds
// `n_lanes` device pointers to (lane_rows[i], ng * 256) f32 inputs.  `images`
// (null: none) is a (Kimg, img_elems) f32 stack read at iog[g]; `cnt` (null:
// none) has ng entries and `code` code_len, a multiple of ng.  smem_bytes of
// dynamic shared memory are reserved per block.  Returns cudaGetLastError()
// after the launch (0 on success).
extern "C" int grid_overhead(int ng, int n_lanes, const void* const* lanes,
                             const int* lane_rows, const int* iog,
                             const float* images, long long img_elems,
                             const int* cnt, const int* code, int code_len,
                             int smem_bytes, float* out, float* checksum,
                             void* stream) {
  if (ng <= 0 || n_lanes < 0 || n_lanes > MAX_LANES || img_elems % 4 != 0 ||
      (cnt != nullptr && (code == nullptr || code_len % ng != 0)) ||
      smem_bytes < 0) {
    return (int)cudaErrorInvalidValue;
  }
  Lanes l = {};
  for (int i = 0; i < n_lanes; ++i) {
    l.ptr[i] = static_cast<const float*>(lanes[i]);
    l.rows[i] = lane_rows[i];
  }
  // raise the kernel's dynamic shared memory limit once (not a stream
  // operation, so the first launch must come before any graph capture)
  static int smem_limit = 48 * 1024;
  if (smem_bytes > smem_limit) {
    const cudaError_t err = cudaFuncSetAttribute(
        grid_overhead_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (err != cudaSuccess) return (int)err;
    smem_limit = smem_bytes;
  }
  grid_overhead_kernel<<<ng, GROUP, smem_bytes, (cudaStream_t)stream>>>(
      l, n_lanes, iog, images, (size_t)img_elems, cnt, code,
      cnt != nullptr ? code_len / ng : 0, out, checksum);
  return (int)cudaGetLastError();
}

extern "C" const char* grid_overhead_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
