// Hamming best-two matcher for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of photometric_bundle_adjustment_tpu/ops/
// hamming.py (`_match_kernel`, launched by `best_two_nn`), batched over a
// worklist of image pairs.  For pair p and each row i of the (N1, 8)-word
// descriptor block d1[a[p]] it finds, over the columns j of d2[b[p]]:
//   best   = min_j dist(i, j),
//   idx    = the lowest j that reaches best,
//   second = min over j != idx of dist(i, j),
// with dist = sum over the 8 words of popcount(d1 ^ d2) (256-bit Hamming)
// and dist = BIG (2^20) for every column whose valid2 flag is 0.  So a
// tie at the best distance gives second == best, no valid column gives
// (BIG, BIG, 0) and one valid column gives second == BIG, as in the TPU
// kernel.  The TPU kernel masks by a column count n2; this kernel takes
// the per-column mask itself, which agrees with the count wherever the
// valid columns are a prefix, and with the XLA route for any mask.
// Output: best, second, idx, each (P, N1) int32, row-major.
//
// What bounds it on the card: the popcount pipe.  Per pair it does
// N1 * N2 * 8 XOR + popcount + add, and reads only 32 B per descriptor
// (the d2 block once per 128-row tile, from L2), so it is bound by
// integer operations, not bytes.  The least time for the same distances
// is an int8 bit-plane product on the tensor cores (H = pop(a) + pop(b)
// - 2 a.b), which this simple kernel does not use.
//
// What the design does about it: one 128-thread block per (pair, 128-row
// tile); each thread keeps its d1 row (8 words) and its running best,
// second and idx in registers, and scans the columns in ascending order
// from a 256-column tile of d2 staged in shared memory.  Every thread of a
// warp reads the same column at once, so shared-memory reads broadcast
// and never conflict.  No (N1, N2) matrix touches device memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileRows = 128;
constexpr int kTileCols = 256;
constexpr int kBig = 1 << 20;

__device__ __forceinline__ int dist256(const uint4& q0, const uint4& q1,
                                       const uint4& c0, const uint4& c1) {
  return __popc(q0.x ^ c0.x) + __popc(q0.y ^ c0.y) + __popc(q0.z ^ c0.z) +
         __popc(q0.w ^ c0.w) + __popc(q1.x ^ c1.x) + __popc(q1.y ^ c1.y) +
         __popc(q1.z ^ c1.z) + __popc(q1.w ^ c1.w);
}

__global__ void __launch_bounds__(kTileRows)
hamming_best_two_kernel(const uint4* __restrict__ d1, int N1,
                        const uint4* __restrict__ d2,
                        const uint8_t* __restrict__ valid2, int N2,
                        const int* __restrict__ a, const int* __restrict__ b,
                        int* __restrict__ best_out,
                        int* __restrict__ second_out,
                        int* __restrict__ idx_out) {
  __shared__ uint4 cols[kTileCols][2];
  __shared__ int col_ok[kTileCols];

  const int p = blockIdx.x;
  const int row = blockIdx.y * kTileRows + threadIdx.x;
  const long long ia = a[p];
  const long long ib = b[p];

  uint4 q0 = make_uint4(0u, 0u, 0u, 0u);
  uint4 q1 = q0;
  if (row < N1) {
    const uint4* q = d1 + (ia * N1 + row) * 2;
    q0 = q[0];
    q1 = q[1];
  }
  const uint4* base2 = d2 + ib * N2 * 2;
  const uint8_t* v2 = valid2 + ib * N2;

  int best = kBig, second = kBig, idx = 0;
  for (int c0 = 0; c0 < N2; c0 += kTileCols) {
    const int n = min(kTileCols, N2 - c0);
    __syncthreads();  // every thread is done with the previous tile
    for (int t = threadIdx.x; t < n; t += kTileRows) {
      cols[t][0] = base2[(long long)(c0 + t) * 2];
      cols[t][1] = base2[(long long)(c0 + t) * 2 + 1];
      col_ok[t] = v2[c0 + t];
    }
    __syncthreads();
    for (int t = 0; t < n; ++t) {
      int d = dist256(q0, q1, cols[t][0], cols[t][1]);
      d = col_ok[t] ? d : kBig;
      if (d < best) {
        second = best;
        best = d;
        idx = c0 + t;
      } else if (d < second) {
        second = d;
      }
    }
  }
  if (row < N1) {
    const long long o = (long long)p * N1 + row;
    best_out[o] = best;
    second_out[o] = second;
    idx_out[o] = idx;
  }
}

}  // namespace

// d1: (I1, N1, 8) uint32, d2: (I2, N2, 8) uint32, valid2: (I2, N2) uint8,
// a, b: (P,) int32 indices into the first axes (the caller checks their
// range); best, second, idx: (P, N1) int32.  Launches on `stream` and
// returns the launch's cudaError_t (0 on success).
extern "C" int hamming_best_two(const uint32_t* d1, int N1, const uint32_t* d2,
                                const uint8_t* valid2, int N2, const int* a,
                                const int* b, int P, int* best, int* second,
                                int* idx, void* stream) {
  if (N1 <= 0 || N2 <= 0 || P <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((unsigned)P, (unsigned)((N1 + kTileRows - 1) / kTileRows));
  hamming_best_two_kernel<<<grid, kTileRows, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const uint4*>(d1), N1,
      reinterpret_cast<const uint4*>(d2), valid2, N2, a, b, best, second,
      idx);
  return (int)cudaGetLastError();
}

extern "C" const char* hamming_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
