// Kernel A, the co-Z masked-swap ladder k_i * P_i, on P-384, one lane per
// thread (NVIDIA Hopper, sm_90a): ladder_lane.cuh over coz.cuh's formulas
// on the P-384 field (field_p384.cuh, 12 32-bit words). ladder.cu
// says what the kernel computes and what bounds it; here one ZDAU step is
// 9 multiplies and 7 squarings of 144 and 78 products, inlined here (the
// lane holds no table; the other P-384 kernels call them). One source a
// curve, so that the builds run side by side. Replaces
// ecsimd_tpu/kernels/ladder.py:_ladder_kernel.

#define EC_INLINE_FIELD_MULS
#include "coz_p384.cuh"

namespace p384 {
#include "ladder_lane.cuh"
}  // namespace p384

namespace {

constexpr int kThreads = 128;

// Two blocks an SM, fe_mul and fe_sqr inlined (EC_INLINE_FIELD_MULS: 215
// registers, no spill; called, the lane took 254), by the card's times
// (PERF.md).
__global__ void __launch_bounds__(kThreads, 2)
ladder_p384_kernel(const int32_t* __restrict__ scalars, const int32_t* __restrict__ xs,
                   const int32_t* __restrict__ ys, int32_t* __restrict__ ax,
                   int32_t* __restrict__ ay, int32_t* __restrict__ z, int64_t B) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  p384::ladder_lane(scalars, xs, ys, ax, ay, z, B, i);
}

}  // namespace

// scalars: (24, B) int32 classical digit planes; xs, ys: (24, B) affine
// coordinates (residues as stored); ax, ay, z: (24, B) outputs. Launches on
// `stream` and returns cudaGetLastError().
extern "C" int ec_ladder_p384(const int32_t* scalars, const int32_t* xs, const int32_t* ys,
                              int32_t* ax, int32_t* ay, int32_t* z, int64_t B,
                              void* stream) {
  if (B > 0) {
    const int64_t blocks = (B + kThreads - 1) / kThreads;
    ladder_p384_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        scalars, xs, ys, ax, ay, z, B);
  }
  return (int)cudaGetLastError();
}
