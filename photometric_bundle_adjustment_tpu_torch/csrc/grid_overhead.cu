// Grid-overhead probe for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of scripts/grid_overhead.py (`run_variant`,
// `run_full_shape`, `run_img_revisit`): they measure the fixed cost of the
// megakernel's grid (ng = 160 steps of a (184, 256) f32 output block) as
// input blocks are added.  One kernel takes every variant.  The result is
// the (184, ng * 256) zeros and, per step g, checksum[g]: the sum of g's 256
// columns of each bound lane input (up to 7, r rows each), of the whole
// (H, W) image iog[g] when an image stack is bound, of iog[g] itself and,
// with the full harness, of cnt[g] and g's code_len / ng entries of code.
// On the TPU a BlockSpec stages its block whether the body reads it or not;
// on the card an unread pointer moves no bytes, so the checksum makes every
// bound byte count.
//
// What bounds it: bytes.  The output is 30.1 MB; the 7 lane inputs add
// 39.0 MB; each distinct image adds 1.72 MB.  The TPU does not copy a block
// again while its index stays the same from one step to the next, so an
// image named by several steps is read once here too.
//
// Design.  The grid is not the TPU's: `plan()` in scripts/grid_overhead.py
// sizes it from the card's SM count (one block of 512 threads per SM) and
// cuts the work into units of at most 64 KB, which every block walks
// round-robin (unit u goes to block u % grid):
//   * output tiles (n_out, a multiple of the grid, so every block zeroes
//     the same share), with 16-byte streaming stores (st.global.cs.v4);
//   * lane units: 64 of the step's concatenated lane rows x its 256 columns,
//     read with 16-byte ld.global.nc loads, 8 in flight per thread (64 KB a
//     block); a step's first unit also sums cnt[g] and its code entries;
//   * image slices of 16,384 floats of each distinct image of iog, found on
//     the device: every block flags the images iog names in shared memory
//     and ranks them in ascending order, so units of unused images do not
//     exist and no host sync sizes anything.
// Each unit writes its block sum (a fixed shuffle tree, then the warps in
// order) to its own slot of a scratch buffer; no float atomics.  The last
// block to finish (an integer ticket, which that block resets to 0, so a
// graph replay starts from 0 again) sums each used image's slices in order,
// then each step's slots in order: two calls give bit-equal checksums.
// The ticket is one per device: calls on one device must not overlap.
//
// The TPU's 4 MiB VMEM scratch does not fit a block: the "scratch" variant
// asks for the most dynamic shared memory a block may take instead (the
// opt-in limit less the kernel's own static shared memory).  With one block
// per SM that costs no occupancy.

#include <cuda_runtime.h>
#include <stddef.h>

constexpr int MAX_LANES = 7;

// the plan's numbers (`Plan` in scripts/grid_overhead.py)
struct Plan {
  long long out4;        // float4 in the output
  long long out_tile4;   // float4 per output tile
  long long img_elems;   // floats per image (0: no image stack)
  int ng;                // TPU grid steps
  int n_out;             // output tiles, a multiple of gridDim.x
  int n_lanes;
  int chunk_rows;        // concatenated lane rows per lane unit
  int n_chunks;          // lane units per step
  int code_per_block;    // code entries per step (0: no cnt/code)
  int kimg;              // images in the stack
  int slice_elems;       // floats per image slice, a multiple of 4
  int n_slices;          // slices per image
  int img_slot0;         // slot of the first image partial
};

struct Lanes {
  const float* ptr[MAX_LANES];
  int row0[MAX_LANES + 1];   // first concatenated row of each lane; total
};

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int DEPTH = 8;                      // 16-byte loads in flight
constexpr int GROUP = 256;
constexpr int GROUP4 = GROUP / 4;
constexpr int ROWS_PER_PASS = THREADS / GROUP4;
constexpr int MAX_IMAGES = 1024;

__device__ unsigned int g_ticket = 0;

__device__ __forceinline__ float sum4(float4 v) {
  return (v.x + v.y) + (v.z + v.w);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// This thread's share of lane unit (g, c): rows [c * chunk_rows, ...) of the
// lanes stacked in order, columns [g * 256, (g + 1) * 256).
__device__ float lane_unit(const Plan& p, const Lanes& lanes,
                           const int* __restrict__ cnt,
                           const int* __restrict__ code, int g, int c) {
  const int t = threadIdx.x;
  const long long ncols = (long long)p.ng * GROUP;
  const int r_lo = c * p.chunk_rows;
  const int r_hi = min(r_lo + p.chunk_rows, lanes.row0[p.n_lanes]);
  const int col = g * GROUP + (t % GROUP4) * 4;
  float acc = 0.0f;
  for (int base = r_lo; base < r_hi; base += DEPTH * ROWS_PER_PASS) {
    float4 v[DEPTH];
#pragma unroll
    for (int d = 0; d < DEPTH; ++d) {
      const int j = base + d * ROWS_PER_PASS + t / GROUP4;
      v[d] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (j < r_hi) {
        int i = 0;
        while (j >= lanes.row0[i + 1]) ++i;
        v[d] = __ldg(reinterpret_cast<const float4*>(
            lanes.ptr[i] + (long long)(j - lanes.row0[i]) * ncols + col));
      }
    }
#pragma unroll
    for (int d = 0; d < DEPTH; ++d) acc += sum4(v[d]);
  }
  if (c == 0 && p.code_per_block > 0) {
    const int* cg = code + (long long)g * p.code_per_block;
    for (int i = t; i < p.code_per_block; i += THREADS) acc += (float)cg[i];
    if (t == 0) acc += (float)cnt[g];
  }
  return acc;
}

// This thread's share of slice s of image k.
__device__ float image_unit(const Plan& p, const float* __restrict__ images,
                            int k, int s) {
  const int t = threadIdx.x;
  const long long lo = (long long)s * p.slice_elems;
  const long long hi = min(lo + p.slice_elems, p.img_elems);
  const float4* im = reinterpret_cast<const float4*>(
      images + (long long)k * p.img_elems + lo);
  const int n4 = (int)((hi - lo) / 4);
  float acc = 0.0f;
  for (int base = 0; base < n4; base += DEPTH * THREADS) {
    float4 v[DEPTH];
#pragma unroll
    for (int d = 0; d < DEPTH; ++d) {
      const int i = base + d * THREADS + t;
      v[d] = i < n4 ? __ldg(im + i) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
#pragma unroll
    for (int d = 0; d < DEPTH; ++d) acc += sum4(v[d]);
  }
  return acc;
}

__global__ void __launch_bounds__(THREADS, 1)
grid_overhead_kernel(const Plan p, const Lanes lanes,
                     const int* __restrict__ iog,
                     const float* __restrict__ images,
                     const int* __restrict__ cnt,
                     const int* __restrict__ code, float* __restrict__ out,
                     float* __restrict__ checksum,
                     float* __restrict__ slots) {
  __shared__ int rank[MAX_IMAGES];     // flags, then rank (-1: unused)
  __shared__ int used[MAX_IMAGES];     // the used images, ascending
  __shared__ float totals[MAX_IMAGES];
  __shared__ float warp_sums[2][WARPS];
  __shared__ Lanes lanes_s;  // indexed at run time: no local-memory copy
  __shared__ int n_used_s;
  __shared__ bool last_s;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int grid = gridDim.x, b = blockIdx.x;
  const bool with_images = images != nullptr;

  // iog's first entries load while the block zeroes its output tiles
  const int my_k = (with_images && t < p.ng) ? __ldg(iog + t) : -1;
  if (with_images)
    for (int k = t; k < p.kimg; k += THREADS) rank[k] = 0;
  if (t == 0) lanes_s = lanes;

  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float4* out4 = reinterpret_cast<float4*>(out);
  for (int u = b; u < p.n_out; u += grid) {
    const long long lo = (long long)u * p.out_tile4;
    const long long hi = min(lo + p.out_tile4, p.out4);
    for (long long i = lo + t; i < hi; i += THREADS) __stcs(out4 + i, zero);
  }

  int n_used = 0;
  __syncthreads();
  if (with_images) {
    for (int g = t; g < p.ng; g += THREADS) {
      const int k = g == t ? my_k : __ldg(iog + g);
      if (k >= 0 && k < p.kimg) rank[k] = 1;
    }
    __syncthreads();
    if (warp == 0) {
      int count = 0;
      for (int base = 0; base < p.kimg; base += 32) {
        const int k = base + lane;
        const bool f = k < p.kimg && rank[k] != 0;
        const unsigned m = __ballot_sync(0xffffffffu, f);
        const int r = count + __popc(m & ((1u << lane) - 1u));
        if (k < p.kimg) rank[k] = f ? r : -1;
        if (f) used[r] = k;
        count += __popc(m);
      }
      if (lane == 0) n_used_s = count;
    }
    __syncthreads();
    n_used = n_used_s;
  }

  // lane units, then image units, each summed into its own slot
  const int n_lane_units = p.ng * p.n_chunks;
  const int n_units = p.n_out + n_lane_units + n_used * p.n_slices;
  int parity = 0;
  for (int u = p.n_out + b; u < n_units; u += grid) {
    const int v = u - p.n_out;
    const int slot = v < n_lane_units ? v : p.img_slot0 + v - n_lane_units;
    float acc;
    if (v < n_lane_units) {
      acc = lane_unit(p, lanes_s, cnt, code, v / p.n_chunks, v % p.n_chunks);
    } else {
      const int w = v - n_lane_units;
      acc = image_unit(p, images, used[w / p.n_slices], w % p.n_slices);
    }
    acc = warp_sum(acc);
    if (lane == 0) warp_sums[parity][warp] = acc;
    __syncthreads();
    if (warp == 0) {
      const float s = warp_sum(lane < WARPS ? warp_sums[parity][lane] : 0.0f);
      if (lane == 0) slots[slot] = s;
    }
    parity ^= 1;
  }

  // the last block to finish sums the slots in a fixed order
  __syncthreads();
  if (t == 0) {
    __threadfence();
    last_s = atomicAdd(&g_ticket, 1u) == (unsigned)grid - 1u;
  }
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  for (int j = warp; j < n_used; j += WARPS) {
    const float* sj = slots + p.img_slot0 + (long long)j * p.n_slices;
    float s = 0.0f;
    for (int q = lane; q < p.n_slices; q += 32) s += __ldcg(sj + q);
    s = warp_sum(s);
    if (lane == 0) totals[j] = s;
  }
  __syncthreads();
  for (int g = t; g < p.ng; g += THREADS) {
    const int k = __ldg(iog + g);
    float cs = (float)k;
    for (int c = 0; c < p.n_chunks; ++c)
      cs += __ldcg(slots + (long long)g * p.n_chunks + c);
    if (with_images)
      cs += (k >= 0 && k < p.kimg) ? totals[rank[k]]
                                   : __int_as_float(0x7fc00000);  // NaN
    checksum[g] = cs;
  }
  if (t == 0) g_ticket = 0;
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

// Launches the probe on `stream` (a cudaStream_t passed as a pointer) with
// `grid` blocks over the work units of `plan` (`plan()` in
// scripts/grid_overhead.py).  `lanes` holds plan->n_lanes device pointers to
// (rows, ng * 256) f32 inputs, `row0` their first rows stacked in order and
// the total.  `images` (null: none) is a (kimg, img_elems) f32 stack read at
// the distinct entries of iog; `cnt` (null: none) has ng entries and `code`
// ng * code_per_block.  out (184, ng * 256) f32 gets zeros, checksum (ng,)
// f32 the sums; `slots` holds the plan's partial sums.  smem_bytes of
// dynamic shared memory are reserved per block.  Returns cudaGetLastError()
// after the launch (0 on success).
extern "C" int grid_overhead(const Plan* plan, int grid,
                             const void* const* lanes, const int* row0,
                             const int* iog, const float* images,
                             const int* cnt, const int* code, int smem_bytes,
                             float* out, float* checksum, float* slots,
                             void* stream) {
  const Plan& p = *plan;
  if (grid <= 0 || p.ng <= 0 || p.n_out % grid != 0 || p.n_lanes < 0 ||
      p.n_lanes > MAX_LANES || p.img_elems % 4 != 0 ||
      p.slice_elems % 4 != 0 || (cnt == nullptr) != (code == nullptr) ||
      (images != nullptr && (p.kimg <= 0 || p.kimg > MAX_IMAGES ||
                             p.slice_elems <= 0)) ||
      smem_bytes < 0) {
    return (int)cudaErrorInvalidValue;
  }
  Lanes l = {};
  for (int i = 0; i < p.n_lanes; ++i)
    l.ptr[i] = static_cast<const float*>(lanes[i]);
  for (int i = 0; i <= MAX_LANES; ++i) l.row0[i] = row0[min(i, p.n_lanes)];
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
  grid_overhead_kernel<<<grid, THREADS, smem_bytes, (cudaStream_t)stream>>>(
      p, l, iog, images, cnt, code, out, checksum, slots);
  return (int)cudaGetLastError();
}

extern "C" const char* grid_overhead_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
