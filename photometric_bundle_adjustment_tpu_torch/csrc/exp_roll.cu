// Windowed-read probe for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of scripts/exp_roll.py (`make`): it tests
// whether a (24, 128) window of a (24, 256) f32 tile can be read at a lane
// shift s known only at run time.  Here one block per tile of a batch of B
// tiles, 256 threads, writes out[b] (24, 128) from x[b] (24, 256) at shift
// shifts[b], in one of three modes:
//   * roll (MODE_ROLL): the tile is staged in shared memory with 16-byte
//     loads, then column c of the window is column (c + s) mod 256;
//   * dynslice (MODE_SLICE): read straight from global memory at the
//     unaligned start s, which must lie in [0, 128]; a window that would
//     leave the tile is written as NaN;
//   * rollstatic (MODE_SLICE with SHIFT 8): the same read with the shift a
//     compile-time constant.
// Every mode is exact (a copy), so the kernel equals its plain version bit
// for bit.
//
// What bounds it: bytes.  At B = 4,096 it reads 100.7 MB and writes 50.3 MB
// (0.045 ms at 3.35 TB/s); at B = 1 a launch is all it measures.

#include <cuda_runtime.h>

namespace {

constexpr int ROWS = 24;
constexpr int COLS = 256;
constexpr int WIN = 128;
constexpr int THREADS = 256;
constexpr int MODE_ROLL = 0;
constexpr int MODE_SLICE = 1;
constexpr int DYNAMIC = -1;    // SHIFT: read the shift from shifts[b]

template <int MODE, int SHIFT>
__global__ void __launch_bounds__(THREADS)
exp_roll_kernel(const float* __restrict__ x, const int* __restrict__ shifts,
                float* __restrict__ out) {
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const float* tile = x + (size_t)b * ROWS * COLS;
  float* o = out + (size_t)b * ROWS * WIN;
  const int s = SHIFT == DYNAMIC ? shifts[b] : SHIFT;

  if constexpr (MODE == MODE_ROLL) {
    __shared__ float4 stage[ROWS * COLS / 4];
    const float4* src = reinterpret_cast<const float4*>(tile);
    for (int i = t; i < ROWS * COLS / 4; i += THREADS) stage[i] = src[i];
    __syncthreads();
    const float* st = reinterpret_cast<const float*>(stage);
    const int sh = ((s % COLS) + COLS) % COLS;
    for (int i = t; i < ROWS * WIN; i += THREADS) {
      const int r = i / WIN, c = i % WIN;
      o[i] = st[r * COLS + ((c + sh) & (COLS - 1))];
    }
  } else {
    const bool inside = s >= 0 && s <= COLS - WIN;
    for (int i = t; i < ROWS * WIN; i += THREADS) {
      const int r = i / WIN, c = i % WIN;
      o[i] = inside ? __ldg(tile + r * COLS + s + c) : __int_as_float(0x7fc00000);
    }
  }
}

}  // namespace

// Launches the probe on `stream` (a cudaStream_t passed as a pointer):
// x (B, 24, 256) f32, shifts (B,) int32, out (B, 24, 128) f32.  mode 0 is
// roll, 1 dynslice, 2 rollstatic (shifts unused).  Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int exp_roll(const float* x, const int* shifts, int B, int mode,
                        float* out, void* stream) {
  if (B <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (mode) {
    case 0:
      exp_roll_kernel<MODE_ROLL, DYNAMIC><<<B, THREADS, 0, st>>>(x, shifts, out);
      break;
    case 1:
      exp_roll_kernel<MODE_SLICE, DYNAMIC><<<B, THREADS, 0, st>>>(x, shifts, out);
      break;
    case 2:
      exp_roll_kernel<MODE_SLICE, 8><<<B, THREADS, 0, st>>>(x, shifts, out);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* exp_roll_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
