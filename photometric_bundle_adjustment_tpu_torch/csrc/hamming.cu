// Hamming best-two matcher for Hopper (sm_90a): both match directions of a
// pair from one distance tile, the distances on the tensor cores.
//
// Replaces the Pallas TPU kernel of photometric_bundle_adjustment_tpu/ops/
// hamming.py:34 (`_match_kernel`, launched by `best_two_nn` once per
// direction), batched over a worklist of image pairs.  For pair p, with
// dist(i, j) the 256-bit Hamming distance between row i of d1[a[p]] and row
// j of d2[b[p]]:
//   forward,  each row i:    best = min_j dist over the valid2 columns,
//                            idx  = the lowest j that reaches best,
//                            second = min over j != idx;
//   backward, each column j: the same over the rows i with valid1 set
//                            (written only when the caller asks for it).
// A masked entry reads as BIG (2^20): a tie at the best gives second ==
// best, nothing valid gives (BIG, BIG, 0), one valid entry second == BIG,
// and every row and column gets an output, valid or not.  The TPU kernel
// masks by a count; this kernel takes the mask itself, which agrees with
// the count wherever the valid entries are a prefix, and with the XLA
// route for any mask.
//
// What bounds it.  The old kernel of this file ran 8 __popc per distance
// and every distance twice (once per direction): the popcount pipe, 16 per
// clock per SM, ran full.  Here one product serves both directions, on the
// tensor cores: mma.m16n8k256 .b1 AND+POPC on the raw words, H = pop(a) +
// pop(b) - 2 pop(a & b), one mma per 16x8 tile and no expansion of the
// bits (an s8 mma on {0, 1} bit planes, eight k-steps a tile plus the
// expansion, took 2.3 times as long on the H100).  The products
// are then cheap next to the epilogue: two best-two reductions of every
// distance, one along each axis, on the integer pipe (about 8 operations
// a distance).  So the kernel is bound by integer
// operations in the epilogue, not by the tensor cores and not by bytes.
//
// What the design does about it.
//   * One block of 4 warps per pair owns all N1 rows and N2 columns, so
//     both reductions finish inside it: no cross-block merge, no atomics,
//     deterministic.  Both descriptor blocks are staged once in shared
//     memory with cp.async (32 B a row, halves swizzled so the fragment
//     loads are free of bank conflicts).
//   * Packed keys: key = (dist << 20) | index, so one min gives the best
//     distance and its lowest index, and best-two is
//     b2 = min(b2, max(b1, k)), b1 = min(b1, k), associative and
//     commutative, so any order of merging is bit-exact.  A key is built
//     with one IMAD from the product: for the row direction
//     key - (pop(a) << 20) = ((pop(b) << 20) | j) - dot << 21, and the row
//     term is added once at the store (likewise for columns).  A masked
//     column or row has base 2^30 | index, above every valid key.
//   * Each warp holds a group of rows as A fragments in registers and walks
//     every 8-column tile of the pair: the row state stays in registers
//     (the four lanes of a quad merge once at the end); the column state
//     of each tile is merged over the warp's rows in registers, then over
//     lane bits 2-4 with shuffles, then into the warp's own slot of
//     shared memory; one pass at the end merges the four warps' slots.
//   * `kBoth = false` skips the column epilogue: `best_two_nn`, the
//     forward half alone, runs the same kernel.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBig = 1 << 20;
constexpr int kShift = 20;                    // key = (dist << 20) | index
constexpr int kIdxMask = (1 << kShift) - 1;
constexpr int kMasked = 1 << 30;              // key base of a masked entry
constexpr int kMaskedT = 1 << 29;             // reduced keys >= this: masked
constexpr int kInf = 0x7fffffff;
constexpr int kDotScale = -(1 << (kShift + 1));
constexpr int kMaxSmem = 227 * 1024;
constexpr int kMT = 8;                        // m-tiles (16 rows) of a warp
constexpr int kRows = 16 * kMT;               // a warp's row group

// Word w of staged row r: the two 16-byte halves of a row swap places in
// every other group of four rows, so that the 8 rows x 4 words a warp reads
// for one fragment fall in 32 distinct banks.
__device__ __forceinline__ int word_at(int r, int w) {
  return (r * 2 + ((w >> 2) ^ ((r >> 2) & 1))) * 4 + (w & 3);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

// Fold a sorted pair (o1 <= o2) into a running best-two (b1 <= b2).
__device__ __forceinline__ void merge(int& b1, int& b2, int o1, int o2) {
  b2 = min(min(b2, o2), max(b1, o1));
  b1 = min(b1, o1);
}

__device__ __forceinline__ void push2(int& b1, int& b2, int k0, int k1) {
  merge(b1, b2, min(k0, k1), max(k0, k1));
}

// 16x8 tile of pop(a & b) over 256 bits; A fragment (rows g, g + 8) x
// (words q, q + 4), B fragment column g, words q and q + 4.
__device__ __forceinline__ void mma_b1(int (&d)[4], const uint32_t* a,
                                       uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "r"(0));
}

// A reduced best-two plus the base it was reduced against -> the outputs.
__device__ __forceinline__ void store(int b1, int b2, int base, long long o,
                                      int* best, int* second, int* idx) {
  const bool ok1 = b1 < kMaskedT, ok2 = b2 < kMaskedT;
  const int k1 = ok1 ? b1 + base : 0;
  best[o] = ok1 ? k1 >> kShift : kBig;
  idx[o] = ok1 ? k1 & kIdxMask : 0;
  second[o] = ok2 ? (b2 + base) >> kShift : kBig;
}

template <bool kBoth>
__global__ void __launch_bounds__(kThreads)
hamming_kernel(const uint4* __restrict__ d1,
               const uint8_t* __restrict__ valid1, int N1,
               const uint4* __restrict__ d2,
               const uint8_t* __restrict__ valid2, int N2,
               const int* __restrict__ a, const int* __restrict__ b,
               int* __restrict__ best12, int* __restrict__ second12,
               int* __restrict__ idx12, int* __restrict__ best21,
               int* __restrict__ second21, int* __restrict__ idx21) {
  const int N1g = (N1 + kRows - 1) / kRows * kRows;
  const int N2p = (N2 + 7) / 8 * 8;

  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* w1 = smem;                          // N1g x 8 words
  uint32_t* w2 = w1 + N1g * 8;                  // N2p x 8 words
  int* pop1 = reinterpret_cast<int*>(w2 + N2p * 8);   // N1g
  int* colbase = pop1 + N1g;                    // N2p, row direction
  int* rowbase = colbase + N2p;                 // N1g, column direction
  int* pop2 = rowbase + N1g;                    // N2p
  int* part = pop2 + N2p;                       // kWarps x N2p x 2

  const int p = blockIdx.x;
  const int tid = threadIdx.x;
  const long long ia = a[p], ib = b[p];
  const uint4* g1 = d1 + ia * N1 * 2;
  const uint4* g2 = d2 + ib * N2 * 2;

  // stage both descriptor blocks; padding rows and columns are zero
  for (int c = tid; c < N1g * 2; c += kThreads) {
    uint32_t* dst = w1 + word_at(c >> 1, 4 * (c & 1));
    if (c < N1 * 2) cp_async16(dst, g1 + c);
    else *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
  }
  for (int c = tid; c < N2p * 2; c += kThreads) {
    uint32_t* dst = w2 + word_at(c >> 1, 4 * (c & 1));
    if (c < N2 * 2) cp_async16(dst, g2 + c);
    else *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // popcounts and key bases
  for (int r = tid; r < N1g; r += kThreads) {
    int s = 0;
#pragma unroll
    for (int w = 0; w < 8; ++w) s += __popc(w1[word_at(r, w)]);
    pop1[r] = s;
    if (kBoth) {
      rowbase[r] = (r < N1 && valid1[ia * N1 + r]) ? (s << kShift) | r
                                                   : kMasked | r;
    }
  }
  for (int c = tid; c < N2p; c += kThreads) {
    int s = 0;
#pragma unroll
    for (int w = 0; w < 8; ++w) s += __popc(w2[word_at(c, w)]);
    colbase[c] = (c < N2 && valid2[ib * N2 + c]) ? (s << kShift) | c
                                                 : kMasked | c;
    if (kBoth) {
      pop2[c] = s;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        part[(w * N2p + c) * 2] = kInf;
        part[(w * N2p + c) * 2 + 1] = kInf;
      }
    }
  }
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  for (int m0 = warp * kRows; m0 < N1g; m0 += kWarps * kRows) {
    uint32_t A[kMT][4];
    int rb1[kMT][2], rb2[kMT][2], rbase[kMT][2];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      const int r0 = m0 + 16 * mt + g, r1 = r0 + 8;
      A[mt][0] = w1[word_at(r0, q)];
      A[mt][1] = w1[word_at(r1, q)];
      A[mt][2] = w1[word_at(r0, q + 4)];
      A[mt][3] = w1[word_at(r1, q + 4)];
      rb1[mt][0] = rb1[mt][1] = rb2[mt][0] = rb2[mt][1] = kInf;
      if constexpr (kBoth) {
        rbase[mt][0] = rowbase[r0];
        rbase[mt][1] = rowbase[r1];
      }
    }

    for (int n0 = 0; n0 < N2p; n0 += 8) {
      const int c = n0 + g;
      int acc[kMT][4];
      const uint32_t b0 = w2[word_at(c, q)], b1 = w2[word_at(c, q + 4)];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) mma_b1(acc[mt], A[mt], b0, b1);

      // row direction: this lane's columns n0 + 2q and n0 + 2q + 1
      const int2 cb = *reinterpret_cast<const int2*>(colbase + n0 + 2 * q);
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          push2(rb1[mt][h], rb2[mt][h], cb.x + acc[mt][2 * h] * kDotScale,
                cb.y + acc[mt][2 * h + 1] * kDotScale);
        }
      }

      if constexpr (kBoth) {
        // column direction: over the warp's rows, then lane bits 2-4
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          int c1 = kInf, c2 = kInf;
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt) {
            push2(c1, c2, rbase[mt][0] + acc[mt][e] * kDotScale,
                  rbase[mt][1] + acc[mt][2 + e] * kDotScale);
          }
#pragma unroll
          for (int s = 4; s < 32; s <<= 1) {
            const int o1 = __shfl_xor_sync(0xffffffffu, c1, s);
            const int o2 = __shfl_xor_sync(0xffffffffu, c2, s);
            merge(c1, c2, o1, o2);
          }
          if (g == 0) {
            int* slot = part + (warp * N2p + n0 + 2 * q + e) * 2;
            merge(c1, c2, slot[0], slot[1]);
            slot[0] = c1;
            slot[1] = c2;
          }
        }
      }
    }

    // rows: merge the four lanes of each quad, then store
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        int r1v = rb1[mt][h], r2v = rb2[mt][h];
#pragma unroll
        for (int s = 1; s < 4; s <<= 1) {
          const int o1 = __shfl_xor_sync(0xffffffffu, r1v, s);
          const int o2 = __shfl_xor_sync(0xffffffffu, r2v, s);
          merge(r1v, r2v, o1, o2);
        }
        const int r = m0 + 16 * mt + 8 * h + g;
        if (((2 * mt + h) & 3) == q && r < N1) {
          store(r1v, r2v, pop1[r] << kShift, (long long)p * N1 + r, best12,
                second12, idx12);
        }
      }
    }
  }

  if constexpr (kBoth) {
    __syncthreads();
    for (int c = tid; c < N2; c += kThreads) {
      int c1 = kInf, c2 = kInf;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        merge(c1, c2, part[(w * N2p + c) * 2], part[(w * N2p + c) * 2 + 1]);
      }
      store(c1, c2, pop2[c] << kShift, (long long)p * N2 + c, best21,
            second21, idx21);
    }
  }
}

size_t smem_bytes(int N1, int N2, bool both) {
  const size_t N1g = (N1 + kRows - 1) / kRows * kRows;
  const size_t N2p = (N2 + 7) / 8 * 8;
  size_t n = 4 * (8 * (N1g + N2p) + N1g + N2p);
  if (both) n += 4 * (N1g + N2p + 2 * kWarps * N2p);
  return n;
}

template <bool kBoth>
int launch(const uint32_t* d1, const uint8_t* valid1, int N1,
           const uint32_t* d2, const uint8_t* valid2, int N2, const int* a,
           const int* b, int P, int* const* out, cudaStream_t stream) {
  const size_t smem = smem_bytes(N1, N2, kBoth);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  auto kernel = hamming_kernel<kBoth>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<P, kThreads, smem, stream>>>(
      reinterpret_cast<const uint4*>(d1), valid1, N1,
      reinterpret_cast<const uint4*>(d2), valid2, N2, a, b, out[0], out[1],
      out[2], out[3], out[4], out[5]);
  return (int)cudaGetLastError();
}

}  // namespace

// d1: (I1, N1, 8) uint32, valid1: (I1, N1) uint8 (unread when out[3] is
// null), d2: (I2, N2, 8) uint32, valid2: (I2, N2) uint8, a, b: (P,) int32
// indices into the first axes (the caller checks their range).  out: best12,
// second12, idx12 (P, N1) int32 and best21, second21, idx21 (P, N2) int32,
// the last three null for the forward half alone.  Launches on `stream` and
// returns a cudaError_t: 0 on success, cudaErrorInvalidValue for empty
// blocks or blocks whose staging needs more than the 227 KB of shared
// memory a block may take (hamming_smem_bytes says how much).
extern "C" int hamming_best_two(const uint32_t* d1, const uint8_t* valid1,
                                int N1, const uint32_t* d2,
                                const uint8_t* valid2, int N2, const int* a,
                                const int* b, int P, int* const* out,
                                void* stream) {
  if (N1 <= 0 || N2 <= 0 || P <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return out[3] != nullptr
             ? launch<true>(d1, valid1, N1, d2, valid2, N2, a, b, P, out, s)
             : launch<false>(d1, valid1, N1, d2, valid2, N2, a, b, P, out, s);
}

// Bytes of dynamic shared memory one block takes for these block sizes.
extern "C" long long hamming_smem_bytes(int N1, int N2, int both) {
  if (N1 <= 0 || N2 <= 0) return 0;
  return (long long)smem_bytes(N1, N2, both != 0);
}

extern "C" const char* hamming_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
