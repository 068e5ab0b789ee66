// Photometric-BA megakernel for Hopper (sm_90a): the warp, the projection
// and its Jacobian computed inside the kernel, on observation rows.
//
// Replaces the Pallas TPU kernel of photometric_bundle_adjustment_tpu/ops/
// pba_mega.py (`_make_kernel`, launched by `mega_rj`) together with the
// XLA warp that fed it (`warp_slabs`).  For every observation column o it
// computes, in registers:
//   * M = Rc^T Ra and u = Rc^T (ta - tc) from the two poses (K, 7) of its
//     anchor and target cameras, and its landmark's inverse depth rho;
//   * for each of the 8 patch bearings d_p: q = M d_p + rho u, the camera
//     model's projection (pinhole, eucm, ds or kb4, the closed forms of
//     core/camera_slab.py) and its Jacobian, and the 13 geometric
//     coefficients of GA and GB (J_geo = gx GA + gy GB);
//   * the bilinear value and x/y gradient of its target image at the
//     projection (exact f32, 4 taps, clamped to [0, W - 1.001] x
//     [0, H - 1.001], zero gradient where a coordinate was clamped);
//     a non-finite projection is sampled at -1e6 and its residual is NaN;
//   * the residual r = (I_t - b_t) - e^(a_t - a_r) (I_ref - b_r), the Huber
//     weight and robust cost, the sqrt-weighted 17-column Jacobian and the
//     Schur payloads A0 = J^T J_rho and A1 = J^T r.
// Output: one (184, N) f32 array, row for row the TPU kernel's layout:
//   [0, 136) J p-major (row p*17 + c), [136, 144) r*sw, 144 cost,
//   [145, 162) A0, [162, 179) A1, [179, 184) zero.
// Inputs per column: cols (4, N) int32 rows [anchor camera, target camera,
// landmark, target image], d3 (24, N) the unit anchor-patch bearings (row
// j*8 + p), intr (8, N) the target intrinsics, refp (8, N) the reference
// patch.  A column whose image index is negative is written as exact zeros
// (the assembly plans gather their dummy entries from such a column).  The
// kernel reads each column's image from its own index: there are no image
// groups and no padding rows.
//
// What bounds it on the card: per observation it reads 176 B of static
// columns, 32 image taps (128 B, mostly from L2) and a few state rows (from
// L2), and writes 736 B of payload: about 0.9 KB of device traffic, under
// a hundred flops per byte even counting the warp.  It is bound by bytes.
// The warp it absorbs ran as about 300 elementwise PyTorch launches that
// wrote 2 x 104 coefficient rows and the pixel planes (896 B per
// observation) for the kernel to read back.
//
// What the design does about it: the warp stays in registers, so the only
// device traffic is the static columns, the taps and the payload.  A block
// of 8 warps covers 32 observations, warp p computing patch point p of
// each: every store of a payload row is a coalesced 128 B line of 32
// neighbouring observations, 54 to 63 registers a thread let 2,048
// threads an SM be resident, so many loads are in flight, and the 8 points
// of an observation share their block's L1 lines.  The per-observation
// sums (|r|^2, then A0 and A1) are reduced over the 8 warps through 36 KB
// of shared memory, in point order.  One thread per observation, the 8
// points in a loop, needed 151 to 176 registers and took 0.0301 ms against
// this mapping's 0.0225 on the EuRoC-scale map (H100, chip_smoke.py).  The
// TPU's window clamp, split-bf16 panels, tile codes and image groups have
// no counterpart here.
//
// Numerics: nvcc contracts a*b + c into FMAs by default, so results differ
// from the plain PyTorch version (ops/pba_mega.py mega_fused_reference:
// warp_slabs then mega_rj_reference) by about one ulp per operation.
//
// The bf16 tier (the TPU kernel's `sample_bf16`) is the same kernel
// instantiated on a bf16 image stack: each tap is widened with
// __bfloat162float and everything after it is f32.  The TPU tier also
// rounds the bilinear y-weights to bf16; this one does not.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int P = 8;          // patch pixels
constexpr int NGEO = 13;      // geometric Jacobian columns
constexpr int NCOL = 17;      // Jacobian columns in W order
constexpr int OUT_ROWS = 184;
constexpr int ROW_RSW = 136;
constexpr int ROW_COST = 144;
constexpr int ROW_A0 = 145;
constexpr int ROW_PAD = 179;
constexpr int OBS = 32;       // observations per block

enum Model { kPinhole = 0, kEucm = 1, kDs = 2, kKb4 = 3 };

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

// Projection of (x, y, z) by the camera model and its Jacobian rows
// J0 = d u / d(x, y, z), J1 = d v / d(x, y, z): the closed forms of
// core/camera_slab.py.  in = [fx, fy, cx, cy, p4, p5, p6, p7].
template <int MODEL>
__device__ __forceinline__ void project(const float* in, float x, float y,
                                        float z, float& u, float& v,
                                        float J0[3], float J1[3]) {
  const float fx = in[0], fy = in[1], cx = in[2], cy = in[3];
  if (MODEL == kPinhole) {
    const float iz = 1.0f / z;
    u = fx * x * iz + cx;
    v = fy * y * iz + cy;
    J0[0] = fx * iz; J0[1] = 0.0f; J0[2] = -fx * x * iz * iz;
    J1[0] = 0.0f; J1[1] = fy * iz; J1[2] = -fy * y * iz * iz;
  } else if (MODEL == kEucm || MODEL == kDs) {
    const float r2 = x * x + y * y;
    float den, dx, dy, dz;
    if (MODEL == kEucm) {
      const float alpha = in[4], beta = in[5];
      const float d = sqrtf(beta * r2 + z * z);
      const float id = 1.0f / d;
      den = alpha * d + (1.0f - alpha) * z;
      dx = alpha * beta * x * id;
      dy = alpha * beta * y * id;
      dz = alpha * z * id + (1.0f - alpha);
    } else {
      const float xi = in[4], alpha = in[5];
      const float d1 = sqrtf(r2 + z * z);
      const float w = xi * d1 + z;
      const float d2 = sqrtf(r2 + w * w);
      const float id1 = 1.0f / d1;
      const float id2 = 1.0f / d2;
      den = alpha * d2 + (1.0f - alpha) * w;
      const float dw_x = xi * x * id1;
      const float dw_y = xi * y * id1;
      const float dw_z = xi * z * id1 + 1.0f;
      dx = alpha * ((x + w * dw_x) * id2) + (1.0f - alpha) * dw_x;
      dy = alpha * ((y + w * dw_y) * id2) + (1.0f - alpha) * dw_y;
      dz = alpha * (w * dw_z * id2) + (1.0f - alpha) * dw_z;
    }
    const float iden = 1.0f / den;
    const float iden2 = iden * iden;
    u = fx * x * iden + cx;
    v = fy * y * iden + cy;
    J0[0] = fx * iden - fx * x * dx * iden2;
    J0[1] = -fx * x * dy * iden2;
    J0[2] = -fx * x * dz * iden2;
    J1[0] = -fy * y * dx * iden2;
    J1[1] = fy * iden - fy * y * dy * iden2;
    J1[2] = -fy * y * dz * iden2;
  } else {  // kKb4
    const float k1 = in[4], k2 = in[5], k3 = in[6], k4 = in[7];
    const float r2 = x * x + y * y;
    const bool safe = r2 > 0.0f;
    const float r = sqrtf(safe ? r2 : 1.0f);
    const float ir = 1.0f / r;
    const float in2 = 1.0f / (r2 + z * z);
    const float theta = atan2f(r, z);
    const float t2 = theta * theta;
    const float dth =
        theta * (1.0f + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4))));
    const float dd =
        1.0f + t2 * (3.0f * k1 +
                     t2 * (5.0f * k2 + t2 * (7.0f * k3 + t2 * 9.0f * k4)));
    const float s = dth * ir;
    const float ds_dx = ir * (dd * z * in2 * x * ir - s * x * ir);
    const float ds_dy = ir * (dd * z * in2 * y * ir - s * y * ir);
    const float ds_dz = ir * (-dd * r * in2);
    // exact-centre limit: s -> 1/z, d s/d(x, y) -> 0
    const float iz = 1.0f / z;
    u = safe ? fx * s * x + cx : cx;
    v = safe ? fy * s * y + cy : cy;
    J0[0] = safe ? fx * (s + x * ds_dx) : fx * iz;
    J0[1] = safe ? fx * x * ds_dy : 0.0f;
    J0[2] = safe ? fx * x * ds_dz : 0.0f;
    J1[0] = safe ? fy * y * ds_dx : 0.0f;
    J1[1] = safe ? fy * (s + y * ds_dy) : fy * iz;
    J1[2] = safe ? fy * y * ds_dz : 0.0f;
  }
}

// Unit quaternion (x, y, z, w) -> rotation matrix (se3.quat_to_matrix).
__device__ __forceinline__ void rotation(const float* q, float R[3][3]) {
  const float x = q[0], y = q[1], z = q[2], w = q[3];
  const float xx = x * x, yy = y * y, zz = z * z;
  const float xy = x * y, xz = x * z, yz = y * z;
  const float wx = w * x, wy = w * y, wz = w * z;
  R[0][0] = 1.0f - 2.0f * (yy + zz);
  R[0][1] = 2.0f * (xy - wz);
  R[0][2] = 2.0f * (xz + wy);
  R[1][0] = 2.0f * (xy + wz);
  R[1][1] = 1.0f - 2.0f * (xx + zz);
  R[1][2] = 2.0f * (yz - wx);
  R[2][0] = 2.0f * (xz - wy);
  R[2][1] = 2.0f * (yz + wx);
  R[2][2] = 1.0f - 2.0f * (xx + yy);
}

struct Inputs {
  const float* pose;       // (K, 7): t (3), q (4)
  const float* affine;     // (K, 2): a, b
  const float* inv_depth;  // (L,)
  const int* cols;         // (4, N): anchor, target, landmark, image
  const float* d3;         // (3P, N)
  const float* intr;       // (8, N)
  const float* refp;       // (P, N)
  int H, W;
  size_t N;
  float huber_delta;
  float* out;              // (184, N)
};

// What one observation shares across its 8 points.
struct Obs {
  float M[3][3], u[3], rho, e, b_r, b_t, in[8];
  int img;
};

__device__ __forceinline__ void load_obs(const Inputs& a, size_t o,
                                         Obs& s) {
  const size_t N = a.N;
  const int an = __ldg(a.cols + o);
  const int tn = __ldg(a.cols + N + o);
  const int lm = __ldg(a.cols + 2 * N + o);
  s.img = __ldg(a.cols + 3 * N + o);
  float pa[7], pc[7];
#pragma unroll
  for (int i = 0; i < 7; ++i) {
    pa[i] = __ldg(a.pose + 7 * an + i);
    pc[i] = __ldg(a.pose + 7 * tn + i);
  }
  float Ra[3][3], Rc[3][3];
  rotation(pa + 3, Ra);
  rotation(pc + 3, Rc);
  // M = Rc^T Ra;  u = Rc^T (ta - tc)
#pragma unroll
  for (int j = 0; j < 3; ++j) {
#pragma unroll
    for (int c = 0; c < 3; ++c)
      s.M[j][c] = Rc[0][j] * Ra[0][c] + Rc[1][j] * Ra[1][c] +
                  Rc[2][j] * Ra[2][c];
    s.u[j] = Rc[0][j] * (pa[0] - pc[0]) + Rc[1][j] * (pa[1] - pc[1]) +
             Rc[2][j] * (pa[2] - pc[2]);
  }
  s.rho = __ldg(a.inv_depth + lm);
  const float a_r = __ldg(a.affine + 2 * an);
  s.b_r = __ldg(a.affine + 2 * an + 1);
  const float a_t = __ldg(a.affine + 2 * tn);
  s.b_t = __ldg(a.affine + 2 * tn + 1);
  s.e = expf(a_t - a_r);
#pragma unroll
  for (int i = 0; i < 8; ++i) s.in[i] = __ldg(a.intr + i * N + o);
}

// Point p of an observation: its pixel (ux, uy; -1e6 where the projection
// is not finite) and its 13 geometric coefficients of GA and GB.
template <int MODEL>
__device__ __forceinline__ void warp_point(const Inputs& a, const Obs& s,
                                           size_t o, int p, float& ux,
                                           float& uy, float GA[NGEO],
                                           float GB[NGEO]) {
  float d[3], q[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) d[j] = __ldg(a.d3 + (j * P + p) * a.N + o);
#pragma unroll
  for (int j = 0; j < 3; ++j)
    q[j] = s.M[j][0] * d[0] + s.M[j][1] * d[1] + s.M[j][2] * d[2] +
           s.rho * s.u[j];
  float u0, v0, J[2][3];
  project<MODEL>(s.in, q[0], q[1], q[2], u0, v0, J[0], J[1]);
  const bool fin = isfinite(u0) && isfinite(v0);
  ux = fin ? u0 : -1e6f;
  uy = fin ? v0 : -1e6f;
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const float* Jp = J[t];
    float* G = t == 0 ? GA : GB;
    float av[3];
#pragma unroll
    for (int c = 0; c < 3; ++c)
      av[c] = Jp[0] * s.M[0][c] + Jp[1] * s.M[1][c] + Jp[2] * s.M[2][c];
    G[0] = s.rho * av[0];                 // dt_a
    G[1] = s.rho * av[1];
    G[2] = s.rho * av[2];
    G[3] = d[1] * av[2] - d[2] * av[1];   // dphi_a: d x a
    G[4] = d[2] * av[0] - d[0] * av[2];
    G[5] = d[0] * av[1] - d[1] * av[0];
    G[6] = -s.rho * Jp[0];                // dt_c
    G[7] = -s.rho * Jp[1];
    G[8] = -s.rho * Jp[2];
    G[9] = Jp[1] * q[2] - Jp[2] * q[1];   // dphi_c: Jpi x q
    G[10] = Jp[2] * q[0] - Jp[0] * q[2];
    G[11] = Jp[0] * q[1] - Jp[1] * q[0];
    G[12] = Jp[0] * s.u[0] + Jp[1] * s.u[1] + Jp[2] * s.u[2];  // drho
  }
}

// Huber weight sqrt and robust cost of |r|^2.
__device__ __forceinline__ void robust(float r2, float delta, float& sw,
                                       float& cost) {
  float w;
  if (delta > 0.0f) {
    const float sq = sqrtf(r2);
    const bool inlier = r2 <= delta * delta;
    w = inlier ? 1.0f : delta / sq;
    cost = 0.5f * (inlier ? r2 : 2.0f * delta * sq - delta * delta);
  } else {
    w = 1.0f;
    cost = 0.5f * r2;
  }
  sw = sqrtf(w);
}

// Jacobian column c (W order [se3_a(6), aff_a(2), se3_c(6), aff_c(2), rho])
// of one point, sqrt-weighted; jg holds gx GA + gy GB.
__device__ __forceinline__ float jac_col(int c, const float jg[NGEO],
                                         float e, float ref, float sw) {
  if (c < 6) return jg[c] * sw;
  if (c == 6) return e * ref * sw;
  if (c == 7) return e * sw;
  if (c < 14) return jg[c - 2] * sw;
  if (c == 14) return -e * ref * sw;
  if (c == 15) return -sw;
  return jg[12] * sw;
}

// Block (32, 8): thread (lane, p) computes point p of observation
// blockIdx.x * 32 + lane.
template <int MODEL, typename T>
__global__ void __launch_bounds__(OBS * P)
mega_kernel(const T* __restrict__ images, Inputs a) {
  __shared__ float r2s[P][OBS];
  __shared__ float red[P][2 * NCOL][OBS];
  const int lane = threadIdx.x;
  const int p = threadIdx.y;
  const size_t N = a.N;
  const size_t o = (size_t)blockIdx.x * OBS + lane;
  const bool live = o < N;
  const bool ok = live && __ldg(a.cols + 3 * N + o) >= 0;

  float jg[NGEO], r = 0.0f, e = 0.0f, ref = 0.0f;
#pragma unroll
  for (int k = 0; k < NGEO; ++k) jg[k] = 0.0f;
  if (ok) {
    Obs s;
    load_obs(a, o, s);
    float ux, uy, GA[NGEO], GB[NGEO];
    warp_point<MODEL>(a, s, o, p, ux, uy, GA, GB);
    float val, gx, gy;
    sample(images + (size_t)s.img * a.H * a.W, a.W, (float)(a.W - 1.001),
           (float)(a.H - 1.001), ux, uy, val, gx, gy);
#pragma unroll
    for (int k = 0; k < NGEO; ++k) jg[k] = gx * GA[k] + gy * GB[k];
    e = s.e;
    ref = __ldg(a.refp + p * N + o) - s.b_r;
    const float rp = (val - s.b_t) - e * ref;
    r = ux > -1e5f ? rp : NAN;
  }
  r2s[p][lane] = r * r;
  __syncthreads();
  float r2 = 0.0f;
#pragma unroll
  for (int q = 0; q < P; ++q) r2 += r2s[q][lane];
  float sw, cost;
  robust(r2, a.huber_delta, sw, cost);
  if (!ok) sw = cost = 0.0f;

  const float rsw = r * sw;
  const float jrho = jg[12] * sw;
  if (live) {
    a.out[(ROW_RSW + p) * N + o] = rsw;
    if (p == 0) a.out[ROW_COST * N + o] = cost;
    if (p < OUT_ROWS - ROW_PAD) a.out[(ROW_PAD + p) * N + o] = 0.0f;
  }
#pragma unroll
  for (int c = 0; c < NCOL; ++c) {
    const float b = jac_col(c, jg, e, ref, sw);
    if (live) a.out[(p * NCOL + c) * N + o] = b;
    red[p][c][lane] = b * jrho;
    red[p][NCOL + c][lane] = b * rsw;
  }
  __syncthreads();
  // A0 and A1: the 34 sums over the 8 points, in point order
  for (int k = p; k < 2 * NCOL; k += P) {
    float acc = 0.0f;
#pragma unroll
    for (int q = 0; q < P; ++q) acc += red[q][k][lane];
    if (live) a.out[(ROW_A0 + k) * N + o] = acc;
  }
}

static_assert(ROW_A0 + 2 * NCOL == ROW_PAD, "A0 and A1 end at the zero rows");

template <int MODEL, typename T>
int launch(const T* images, const Inputs& a, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((a.N + OBS - 1) / OBS);
  mega_kernel<MODEL, T><<<blocks, dim3(OBS, P), 0, stream>>>(images, a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_model(int model, const T* images, const Inputs& a,
                 cudaStream_t stream) {
  switch (model) {
    case kPinhole: return launch<kPinhole>(images, a, stream);
    case kEucm: return launch<kEucm>(images, a, stream);
    case kDs: return launch<kDs>(images, a, stream);
    case kKb4: return launch<kKb4>(images, a, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Launches the megakernel on `stream` (a cudaStream_t passed as a pointer).
// model: 0 pinhole, 1 eucm, 2 ds, 3 kb4; bf16: the image stack is
// (Kimg, H, W) bf16, else f32.  Every index in cols must be in range
// (the camera of pose/affine, the landmark of inv_depth, the image of the
// stack, or a negative image for a zero column).  Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int pba_mega_fused(int model, int bf16, const void* images,
                              int H, int W, const float* pose,
                              const float* affine,
                              const float* inv_depth, const int* cols,
                              const float* d3, const float* intr,
                              const float* refp, int N, float huber_delta,
                              float* out, void* stream) {
  if (N <= 0 || H < 2 || W < 2) return (int)cudaErrorInvalidValue;
  const Inputs a{pose, affine, inv_depth, cols, d3, intr, refp,
                 H, W, (size_t)N, huber_delta, out};
  const cudaStream_t s = (cudaStream_t)stream;
  if (bf16) return launch_model(model, (const __nv_bfloat16*)images, a, s);
  return launch_model(model, (const float*)images, a, s);
}

extern "C" const char* pba_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
