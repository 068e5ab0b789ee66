// Photometric-BA megakernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of photometric_bundle_adjustment_tpu/ops/
// pba_mega.py (`_make_kernel`, launched by `mega_rj`).  For every patch
// observation it computes, in one pass:
//   * the bilinear value and x/y image gradient at the 8 warped patch
//     pixels (exact f32, 4 taps each, straight from the f32 image);
//   * the residual r = (I_t - b_t) - e^(a_t - a_r) (I_ref - b_r), NaN where
//     the projection was non-finite (encoded by warp_slabs as ux = -1e6);
//   * the Huber weight and robust cost;
//   * the sqrt-weighted 17-column Jacobian J_geo = gx GA + gy GB plus the
//     4 affine columns;
//   * the Schur payloads A0 = J^T J_rho and A1 = J^T r.
// Output: one (184, Og) f32 array, row for row the TPU kernel's layout:
//   [0, 136) J p-major (row p*17 + c), [136, 144) r*sw, 144 cost,
//   [145, 162) A0, [162, 179) A1, [179, 184) zero.
// Rows with lane >= cnt of their 256-row group are written as exact zeros:
// the chunk plans gather their dummy entries from such a row.
//
// What bounds it on the card: per observation it reads ux/uy (64 B), GA/GB
// (832 B), refp and the affine slab (48 B) and 32 image taps (128 B, mostly
// from L2), and writes 736 B: about 1.8 KB of device traffic, about 44 MB
// per build at 24k observations, against well under a hundred flops per
// byte.  It is bandwidth- and launch-bound, not compute-bound.
//
// What the design does about it: one thread per observation column, so a
// warp reads and writes 32 neighbouring addresses of every plane-layout row
// (coalesced 128 B transactions for GA/GB and all 184 output rows); the
// samples, residuals and Jacobian columns live in registers and never touch
// device memory; one 256-thread block per group, so a block samples one
// image, which stays in L2.  The TPU's window clamp, split-bf16 panels and
// tile codes have no counterpart here: sampling reads the image directly.
//
// Numerics: nvcc contracts a*b + c into FMAs by default, so results differ
// from the plain PyTorch version (ops/pba_mega.py mega_rj_reference) by about
// one ulp per operation; tests hold it at atol 1e-4 * max|ref|.
//
// The bf16 tier (the TPU kernel's `sample_bf16`, entry pba_mega_rj_bf16)
// is the same kernel instantiated on a bf16 image stack: each tap is
// widened with __bfloat162float and everything after it is f32, so it
// halves the stack's bytes and differs from the plain version on the
// widened stack only by the same FMA ulps.  The TPU tier also rounds the
// bilinear y-weights to bf16; this one does not.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int P = 8;          // patch pixels
constexpr int GROUP = 256;    // observations per group (one block)
constexpr int NGEO = 13;      // geometric Jacobian columns
constexpr int NCOL = 17;      // Jacobian columns in W order
constexpr int OUT_ROWS = 184;
constexpr int ROW_RSW = 136;
constexpr int ROW_COST = 144;
constexpr int ROW_A0 = 145;
constexpr int ROW_A1 = 162;
constexpr int ROW_PAD = 179;

__device__ __forceinline__ float texel(const float* p) { return __ldg(p); }
__device__ __forceinline__ float texel(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}

// Bilinear value and gradient with the gather sampler's semantics: clamp to
// [0, W - 1.001] x [0, H - 1.001]; a clamped coordinate has zero gradient.
template <typename T>
__device__ __forceinline__ void sample(const T* __restrict__ img, int W,
                                       float xmax, float ymax, float u,
                                       float v, float& val, float& gx,
                                       float& gy) {
  const float x = fminf(fmaxf(u, 0.0f), xmax);
  const float y = fminf(fmaxf(v, 0.0f), ymax);
  const float x0 = floorf(x);
  const float y0 = floorf(y);
  const float fx = x - x0;
  const float fy = y - y0;
  const T* t = img + (size_t)y0 * W + (size_t)x0;
  const float v00 = texel(t);
  const float v01 = texel(t + 1);
  const float v10 = texel(t + W);
  const float v11 = texel(t + W + 1);
  val = v00 * (1.0f - fx) * (1.0f - fy) + v01 * fx * (1.0f - fy) +
        v10 * (1.0f - fx) * fy + v11 * fx * fy;
  gx = (v01 - v00) * (1.0f - fy) + (v11 - v10) * fy;
  gy = (v10 - v00) * (1.0f - fx) + (v11 - v01) * fx;
  if (!(u >= 0.0f && u <= xmax)) gx = 0.0f;
  if (!(v >= 0.0f && v <= ymax)) gy = 0.0f;
}

template <typename T>
__global__ void __launch_bounds__(GROUP)
pba_mega_rj_kernel(const T* __restrict__ images, int H, int W,
                   const float* __restrict__ ux, const float* __restrict__ uy,
                   const float* __restrict__ GA, const float* __restrict__ GB,
                   const float* __restrict__ refp,
                   const float* __restrict__ aff,
                   const int* __restrict__ iog, const int* __restrict__ cnt,
                   int Og, float huber_delta, float* __restrict__ out) {
  const int g = blockIdx.x;
  const int lane = threadIdx.x;
  const size_t o = (size_t)g * GROUP + lane;
  const size_t og = (size_t)Og;

  if (lane >= cnt[g]) {
#pragma unroll 8
    for (int row = 0; row < OUT_ROWS; ++row) out[row * og + o] = 0.0f;
    return;
  }

  const T* img = images + (size_t)iog[g] * H * W;
  const float xmax = (float)(W - 1.001);
  const float ymax = (float)(H - 1.001);

  const float a_r = aff[o];
  const float b_r = aff[og + o];
  const float a_t = aff[2 * og + o];
  const float b_t = aff[3 * og + o];
  const float e = expf(a_t - a_r);

  float gx[P], gy[P], ref[P], r[P];
  float r2 = 0.0f;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const float u = ux[p * og + o];
    const float v = uy[p * og + o];
    float val;
    sample(img, W, xmax, ymax, u, v, val, gx[p], gy[p]);
    ref[p] = refp[p * og + o] - b_r;
    const float rp = (val - b_t) - e * ref[p];
    r[p] = (u > -1e5f) ? rp : NAN;
    r2 += r[p] * r[p];
  }

  float w, cost;
  if (huber_delta > 0.0f) {
    const float sq = sqrtf(r2);
    const bool inlier = r2 <= huber_delta * huber_delta;
    w = inlier ? 1.0f : huber_delta / sq;
    cost = 0.5f * (inlier ? r2
                          : 2.0f * huber_delta * sq - huber_delta * huber_delta);
  } else {
    w = 1.0f;
    cost = 0.5f * r2;
  }
  const float sw = sqrtf(w);

  float jrho[P], rsw[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const size_t k = (size_t)(12 * P + p) * og + o;
    jrho[p] = (gx[p] * GA[k] + gy[p] * GB[k]) * sw;
    rsw[p] = r[p] * sw;
    out[(ROW_RSW + p) * og + o] = rsw[p];
  }
  out[ROW_COST * og + o] = cost;

  // Jacobian columns in W order: [se3_a(6), aff_a(2), se3_c(6), aff_c(2), rho]
#pragma unroll
  for (int c = 0; c < NCOL; ++c) {
    float a0 = 0.0f, a1 = 0.0f;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      float b;
      if (c < 6 || (c >= 8 && c < 14)) {
        const int kcol = c < 6 ? c : c - 2;
        const size_t k = (size_t)(kcol * P + p) * og + o;
        b = (gx[p] * GA[k] + gy[p] * GB[k]) * sw;
      } else if (c == 6) {
        b = e * ref[p] * sw;
      } else if (c == 7) {
        b = e * sw;
      } else if (c == 14) {
        b = -e * ref[p] * sw;
      } else if (c == 15) {
        b = -sw;
      } else {
        b = jrho[p];
      }
      out[(p * NCOL + c) * og + o] = b;
      a0 += b * jrho[p];
      a1 += b * rsw[p];
    }
    out[(ROW_A0 + c) * og + o] = a0;
    out[(ROW_A1 + c) * og + o] = a1;
  }
#pragma unroll
  for (int row = ROW_PAD; row < OUT_ROWS; ++row) out[row * og + o] = 0.0f;
}

static_assert(NGEO * P == 104, "GA/GB hold 13 columns of 8 patch rows");

}  // namespace

template <typename T>
static int launch(const T* images, int H, int W, const float* ux,
                  const float* uy, const float* GA, const float* GB,
                  const float* refp, const float* aff, const int* iog,
                  const int* cnt, int Og, float huber_delta, float* out,
                  void* stream) {
  if (Og <= 0 || Og % GROUP != 0 || H < 2 || W < 2) {
    return (int)cudaErrorInvalidValue;
  }
  pba_mega_rj_kernel<T><<<Og / GROUP, GROUP, 0, (cudaStream_t)stream>>>(
      images, H, W, ux, uy, GA, GB, refp, aff, iog, cnt, Og, huber_delta,
      out);
  return (int)cudaGetLastError();
}

// Launches the megakernel on `stream` (a cudaStream_t passed as a pointer).
// Og must be a positive multiple of 256; iog/cnt hold Og / 256 entries.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int pba_mega_rj(const float* images, int H, int W, const float* ux,
                           const float* uy, const float* GA, const float* GB,
                           const float* refp, const float* aff, const int* iog,
                           const int* cnt, int Og, float huber_delta,
                           float* out, void* stream) {
  return launch(images, H, W, ux, uy, GA, GB, refp, aff, iog, cnt, Og,
                huber_delta, out, stream);
}

// The bf16 tier: as pba_mega_rj on a (Kimg, H, W) bf16 image stack.
extern "C" int pba_mega_rj_bf16(const __nv_bfloat16* images, int H, int W,
                                const float* ux, const float* uy,
                                const float* GA, const float* GB,
                                const float* refp, const float* aff,
                                const int* iog, const int* cnt, int Og,
                                float huber_delta, float* out, void* stream) {
  return launch(images, H, W, ux, uy, GA, GB, refp, aff, iog, cnt, Og,
                huber_delta, out, stream);
}

extern "C" const char* pba_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
