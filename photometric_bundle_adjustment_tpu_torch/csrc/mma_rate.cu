// Sustained rate of warp-level tensor-core products (mma.sync) on this
// card, in the two forms a Hamming distance can take:
//   b1: mma.m16n8k256 .b1 AND+POPC, the product of csrc/hamming.cu;
//   s8: mma.m16n8k32 .s8, the int8 product on {0, 1} bit planes.
// NVIDIA's data sheet gives the H100's dense int8 rate (1,979 TOP/s, for
// wgmma) and no b1 rate, so chip_smoke.py measures the b1 rate here for
// the Hamming kernel's bound (the faster of the int8 peak and this), and
// the s8 rate beside it as a check of the method against the data sheet.
// Not a port of a TPU kernel: a measurement of the card.
//
// Each warp runs kChains independent accumulators through `iters` rounds
// of one mma each, on operands held in registers, so the loop touches no
// memory and its time is the tensor pipe's.  An mma of K terms does
// 2 x 16 x 8 x K operations (a multiply, or AND, and an add per term), as
// the data sheet counts int8.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChains = 8;

template <int F>
__device__ __forceinline__ void mma(int (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  if constexpr (F == 0) {
    asm volatile(
        "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
}

template <int F>
__global__ void __launch_bounds__(kThreads)
mma_rate_kernel(int iters, int* __restrict__ sink) {
  const uint32_t t = (blockIdx.x * kThreads + threadIdx.x) * 0x9E3779B9u;
  const uint32_t a[4] = {t, t ^ 0x55555555u, t * 3u + 1u, ~t};
  const uint32_t b[2] = {t >> 7, t ^ 0x0F0F0F0Fu};
  int d[kChains][4] = {};
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int c = 0; c < kChains; ++c) mma<F>(d[c], a, b);
  }
  int s = 0;
#pragma unroll
  for (int c = 0; c < kChains; ++c) s += d[c][0] ^ d[c][1] ^ d[c][2] ^ d[c][3];
  sink[blockIdx.x * kThreads + threadIdx.x] = s;  // keeps the products live
}

}  // namespace

// form: 0 for b1, 1 for s8.  Launches `blocks` blocks of 8 warps, each warp
// running `iters` x 8 mma, on `stream`; sink: blocks x 256 int32 of
// scratch.  Writes the operations launched to *ops and returns a
// cudaError_t (cudaErrorInvalidValue for a bad form or an empty launch).
extern "C" int mma_rate(int form, int blocks, int iters, int* sink,
                        long long* ops, void* stream) {
  if ((form != 0 && form != 1) || blocks <= 0 || iters <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const long long k = form == 0 ? 256 : 32;
  *ops = (long long)blocks * (kThreads / 32) * iters * kChains * 2 * 16 * 8 *
         k;
  cudaStream_t s = (cudaStream_t)stream;
  if (form == 0) {
    mma_rate_kernel<0><<<blocks, kThreads, 0, s>>>(iters, sink);
  } else {
    mma_rate_kernel<1><<<blocks, kThreads, 0, s>>>(iters, sink);
  }
  return (int)cudaGetLastError();
}
