// Kernel I: int32 throughput calibration, one element per thread (NVIDIA
// Hopper, sm_90a).
//
// Replaces ecsimd_tpu/bench/roofline.py:_calib_kernel, which measures the
// TPU vector unit's int32 rate. Each element runs the same 8 independent
// chains, each step a multiply, a mask, an add, a logical shift right and
// an add, reps / 4 x 4 times (the TPU kernel's loop of 4 unrolled steps),
// and writes the sum of the chains; every operation wraps mod 2^32, as
// int32 does on the TPU. Plain version: bench/roofline.calib_plain.
//
// What bounds it: integer issue. Per chain step one IMAD and three or four
// ALU instructions, on 8 independent chains per thread for ILP; no memory
// traffic beyond two loads and a store per thread. The grid is chosen by
// the caller to fill every SM.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChains = 8;

__global__ void __launch_bounds__(kThreads)
calib_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
             int32_t* __restrict__ out, int64_t n, int64_t reps) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint32_t av = (uint32_t)a[i], bv = (uint32_t)b[i];
  uint32_t acc[kChains];
#pragma unroll
  for (int c = 0; c < kChains; ++c) acc[c] = av + (uint32_t)c;
#pragma unroll 1
  for (int64_t r = 0; r < reps / 4; ++r) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
#pragma unroll
      for (int c = 0; c < kChains; ++c) {
        uint32_t x = acc[c] * bv;
        x = (x & 0xFFFFu) + av;
        acc[c] = (x >> 1) + bv;
      }
    }
  }
  uint32_t s = acc[0];
#pragma unroll
  for (int c = 1; c < kChains; ++c) s += acc[c];
  out[i] = (int32_t)s;
}

}  // namespace

// a, b, out: n int32 elements; reps: chain steps (rounded down to a
// multiple of 4). Launches on `stream` and returns cudaGetLastError().
extern "C" int ec_calib(const int32_t* a, const int32_t* b, int32_t* out, int64_t n,
                        int64_t reps, void* stream) {
  if (n > 0) {
    const int64_t blocks = (n + kThreads - 1) / kThreads;
    calib_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(a, b, out, n, reps);
  }
  return (int)cudaGetLastError();
}
