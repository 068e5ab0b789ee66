// Photometric patch sampling for Hopper (sm_90a), on observation columns.
//
// Replaces the Pallas TPU kernel of photometric_bundle_adjustment_tpu/ops/
// patch_sample.py (`_make_kernel`, launched by `sample_patches_grouped`).
// For each observation column o and patch point p it writes the bilinear
// value and the x/y image gradient of the column's own image img[o] at
// (ux[p, o], uy[p, o]):
//   * exact 4-tap bilinear in f32, coordinates clamped to
//     [0, W - 1.001] x [0, H - 1.001], zero gradient where a coordinate was
//     clamped (the gather sampler's and the megakernel's semantics);
//   * a column with img[o] < 0 is written as exact zeros;
//   * want_grads == 0 writes zero gradients.
// Inputs are finite: callers map a non-finite projection to -1e6, which
// clamps to the corner with zero gradient.
//
// What bounds it on the card: per patch point it reads ux/uy (8 B), the
// column's image index (4 B per observation) and 4 image taps (16 B, which
// neighbouring points share through L1/L2) and writes 12 B, against about
// 20 flops: it is bound by bytes, at roughly 24 B of compulsory traffic per
// point.
//
// What the design does about it: one thread per (patch point, observation),
// a block of 32 observations by their 8 points: a warp reads and writes 32
// neighbouring addresses of one plane-layout row (coalesced 128 B
// transactions), and the 8 points of an observation, whose taps overlap,
// run in one block and share its L1 lines.  The columns are the caller's rows as they are: the TPU
// kernel's 128-row image groups, its padding rows and the permutations
// around them have no counterpart here, and neither do its
// (8, 128)-aligned windows, its tile contraction val = wy tile wx^T or its
// packed tile-start codes: each thread reads its 4 taps.
//
// Numerics: nvcc contracts a*b + c into FMAs by default, so values differ
// from the plain PyTorch version (ops/patch_sample.py
// sample_patches_reference) by a few ulps of the image scale.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int P = 8;          // patch points per observation
constexpr int OBS = 32;       // observation columns per block

__global__ void __launch_bounds__(OBS * P)
patch_sample_kernel(const float* __restrict__ images, int H, int W,
                    const float* __restrict__ ux, const float* __restrict__ uy,
                    const int* __restrict__ img_of, int O, int want_grads,
                    float* __restrict__ val, float* __restrict__ gx,
                    float* __restrict__ gy) {
  const int o = blockIdx.x * OBS + threadIdx.x;
  if (o >= O) return;
  const size_t i = (size_t)threadIdx.y * O + o;
  const int im = __ldg(img_of + o);

  float v = 0.0f, dx = 0.0f, dy = 0.0f;
  if (im >= 0) {
    const float* __restrict__ img = images + (size_t)im * H * W;
    const float xmax = (float)(W - 1.001);
    const float ymax = (float)(H - 1.001);
    const float u = __ldg(ux + i);
    const float w = __ldg(uy + i);
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

// images: (Kimg, H, W) f32; ux, uy, val, gx, gy: (8, O) f32; img: (O,)
// int32, the image of each column (below Kimg), negative for a zero
// column.  Launches on `stream` (a cudaStream_t passed as a pointer) and
// returns cudaGetLastError() after the launch (0 on success).
extern "C" int patch_sample(const float* images, int H, int W, const float* ux,
                            const float* uy, const int* img, int O,
                            int want_grads, float* val, float* gx, float* gy,
                            void* stream) {
  if (O <= 0 || H < 2 || W < 2) return (int)cudaErrorInvalidValue;
  patch_sample_kernel<<<(O + OBS - 1) / OBS, dim3(OBS, P), 0,
                        (cudaStream_t)stream>>>(
      images, H, W, ux, uy, img, O, want_grads, val, gx, gy);
  return (int)cudaGetLastError();
}

extern "C" const char* patch_sample_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
