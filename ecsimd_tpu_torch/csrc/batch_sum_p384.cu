// Kernel M, one level of the batch reduction tree of multi-scalar
// multiplication, on P-384, one output lane per thread (NVIDIA Hopper,
// sm_90a): batch_sum_lane.cuh over the curve's formulas on the P-384 field
// (field_p384.cuh, 12 32-bit words, the multiplies called). batch_sum.cu says
// what the kernel computes and what bounds it. One source a curve, so that
// the builds run side by side. Replaces ecsimd_tpu/curves/group.py:batch_sum
// (plain XLA, no Pallas kernel).

#include "coz_p384.cuh"

namespace p384 {
#include "batch_sum_lane.cuh"
}  // namespace p384

#include "batch_sum_kernel.cuh"

namespace {

EC_BATCH_SUM_KERNEL(batch_sum_p384_kernel, p384)

}  // namespace

// xs, ys, zs: (24, n) Jacobian planes (residues as stored); ox, oy, oz:
// (24, (n + 1) / 2) outputs. Launches on `stream` and returns
// cudaGetLastError().
extern "C" int ec_batch_sum_p384(const int32_t* xs, const int32_t* ys, const int32_t* zs,
                                 int32_t* ox, int32_t* oy, int32_t* oz, int64_t n,
                                 void* stream) {
  return batch_sum::launch(batch_sum_p384_kernel, xs, ys, zs, ox, oy, oz, n, stream);
}
