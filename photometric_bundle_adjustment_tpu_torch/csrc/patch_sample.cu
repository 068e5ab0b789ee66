// Photometric patch sampling for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of photometric_bundle_adjustment_tpu/ops/
// patch_sample.py (`_make_kernel`, launched by `sample_patches_grouped`).
// Observations are sorted by target image in groups of 128 rows (every
// group samples one image); for each observation column o and patch point p
// it writes the bilinear value and the x/y image gradient of the group's
// image at (ux[p, o], uy[p, o]):
//   * exact 4-tap bilinear in f32, coordinates clamped to
//     [0, W - 1.001] x [0, H - 1.001], zero gradient where a coordinate was
//     clamped (the gather sampler's and the megakernel's semantics);
//   * rows with lane >= cnt of their group are written as exact zeros;
//   * want_grads == 0 writes zero gradients.
// Inputs are finite: callers map a non-finite projection to -1e6, which
// clamps to the corner with zero gradient.
//
// What bounds it on the card: per patch point it reads ux/uy (8 B) and 4
// image taps (16 B, which neighbouring points share through L1/L2) and
// writes 12 B, against about 20 flops: it is bound by bytes, at roughly
// 24 B of compulsory traffic per point.
//
// What the design does about it: one thread per (patch point, observation)
// and one 128 x 8 block per group, so a warp reads and writes 32
// neighbouring addresses of one plane-layout row (coalesced 128 B
// transactions); every block samples one image, and its points cluster
// where the group's landmarks project, so the taps come from L1/L2.  The
// TPU kernel's (8, 128)-aligned windows, its tile contraction
// val = wy tile wx^T and its packed tile-start codes exist for Mosaic's
// layout rules and have no counterpart here: each thread reads its 4 taps.
//
// Numerics: nvcc contracts a*b + c into FMAs by default, so values differ
// from the plain PyTorch version (ops/patch_sample.py
// sample_patches_reference) by a few ulps of the image scale.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int P = 8;        // patch points per observation
constexpr int GROUP = 128;  // observation rows per group (one block)

__global__ void __launch_bounds__(GROUP * P)
patch_sample_kernel(const float* __restrict__ images, int H, int W,
                    const float* __restrict__ ux, const float* __restrict__ uy,
                    const int* __restrict__ iog, const int* __restrict__ cnt,
                    int Opad, int want_grads, float* __restrict__ val,
                    float* __restrict__ gx, float* __restrict__ gy) {
  const int g = blockIdx.x;
  const int lane = threadIdx.x;
  const size_t i = (size_t)threadIdx.y * Opad + (size_t)g * GROUP + lane;

  float v = 0.0f, dx = 0.0f, dy = 0.0f;
  if (lane < cnt[g]) {
    const float* __restrict__ img = images + (size_t)iog[g] * H * W;
    const float xmax = (float)(W - 1.001);
    const float ymax = (float)(H - 1.001);
    const float u = ux[i];
    const float w = uy[i];
    const float x = fminf(fmaxf(u, 0.0f), xmax);
    const float y = fminf(fmaxf(w, 0.0f), ymax);
    const float x0 = floorf(x);
    const float y0 = floorf(y);
    const float fx = x - x0;
    const float fy = y - y0;
    const float* t = img + (size_t)y0 * W + (size_t)x0;
    const float v00 = __ldg(t);
    const float v01 = __ldg(t + 1);
    const float v10 = __ldg(t + W);
    const float v11 = __ldg(t + W + 1);
    v = v00 * (1.0f - fx) * (1.0f - fy) + v01 * fx * (1.0f - fy) +
        v10 * (1.0f - fx) * fy + v11 * fx * fy;
    if (want_grads) {
      if (u >= 0.0f && u <= xmax) dx = (v01 - v00) * (1.0f - fy) + (v11 - v10) * fy;
      if (w >= 0.0f && w <= ymax) dy = (v10 - v00) * (1.0f - fx) + (v11 - v01) * fx;
    }
  }
  val[i] = v;
  gx[i] = dx;
  gy[i] = dy;
}

}  // namespace

// images: (Kimg, H, W) f32; ux, uy, val, gx, gy: (8, Opad) f32; iog, cnt:
// (Opad / 128,) int32, the image and valid-row count of each group (every
// iog entry must name an image of the stack).  Opad must be a positive
// multiple of 128.  Launches on `stream` (a cudaStream_t passed as a pointer) and
// returns cudaGetLastError() after the launch (0 on success).
extern "C" int patch_sample(const float* images, int H, int W, const float* ux,
                            const float* uy, const int* iog, const int* cnt,
                            int Opad, int want_grads, float* val, float* gx,
                            float* gy, void* stream) {
  if (Opad <= 0 || Opad % GROUP != 0 || H < 2 || W < 2) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 block(GROUP, P);
  patch_sample_kernel<<<Opad / GROUP, block, 0, (cudaStream_t)stream>>>(
      images, H, W, ux, uy, iog, cnt, Opad, want_grads, val, gx, gy);
  return (int)cudaGetLastError();
}

extern "C" const char* patch_sample_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
