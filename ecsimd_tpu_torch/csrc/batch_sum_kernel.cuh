// Kernel M's kernel and launcher, one level of the batch reduction tree of
// multi-scalar multiplication, one output lane per thread (NVIDIA Hopper,
// sm_90a). batch_sum.cu (P-256, secp256k1, Wei25519), batch_sum_p384.cu and
// batch_sum_p521.cu include batch_sum_lane.cuh inside each curve's
// namespace, then this file, instantiate EC_BATCH_SUM_KERNEL once a curve
// and call launch() from their extern "C" entries.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace batch_sum {

constexpr int kThreads = 128;

// The kernel over NS::batch_sum_lane: thread i writes output lane i of the
// level, i < n - n / 2.
#define EC_BATCH_SUM_KERNEL(NAME, NS)                                                       \
  __global__ void __launch_bounds__(batch_sum::kThreads)                                    \
  NAME(const int32_t* __restrict__ xs, const int32_t* __restrict__ ys,                      \
       const int32_t* __restrict__ zs, int32_t* __restrict__ ox, int32_t* __restrict__ oy,  \
       int32_t* __restrict__ oz, int64_t n) {                                               \
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;                       \
    if (i >= n - n / 2) return;                                                             \
    NS::batch_sum_lane(xs, ys, zs, ox, oy, oz, n, i);                                       \
  }

// xs, ys, zs: (D, n) Jacobian planes in the field's internal form; ox, oy,
// oz: (D, (n + 1) / 2) outputs. Launches on `stream` (nothing for n < 2)
// and returns cudaGetLastError().
template <class Kernel>
int launch(Kernel kernel, const int32_t* xs, const int32_t* ys, const int32_t* zs,
           int32_t* ox, int32_t* oy, int32_t* oz, int64_t n, void* stream) {
  if (n > 1) {
    const int64_t blocks = (n - n / 2 + kThreads - 1) / kThreads;
    kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(xs, ys, zs, ox, oy, oz, n);
  }
  return (int)cudaGetLastError();
}

}  // namespace batch_sum
