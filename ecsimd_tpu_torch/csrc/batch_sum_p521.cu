// Kernel M, one level of the batch reduction tree of multi-scalar
// multiplication, on P-521, one output lane per thread (NVIDIA Hopper,
// sm_90a): batch_sum_lane.cuh over the curve's formulas on the P-521 field
// (field_p521.cuh, 17 32-bit words, the multiplies called). batch_sum.cu says
// what the kernel computes and what bounds it. One source a curve, so that
// the builds run side by side. Replaces ecsimd_tpu/curves/group.py:batch_sum
// (plain XLA, no Pallas kernel).

#include "coz_p521.cuh"

namespace p521 {
#include "batch_sum_lane.cuh"
}  // namespace p521

#include "batch_sum_kernel.cuh"

namespace {

EC_BATCH_SUM_KERNEL(batch_sum_p521_kernel, p521)

}  // namespace

// xs, ys, zs: (33, n) Jacobian planes (residues as stored); ox, oy, oz:
// (33, (n + 1) / 2) outputs. Launches on `stream` and returns
// cudaGetLastError().
extern "C" int ec_batch_sum_p521(const int32_t* xs, const int32_t* ys, const int32_t* zs,
                                 int32_t* ox, int32_t* oy, int32_t* oz, int64_t n,
                                 void* stream) {
  return batch_sum::launch(batch_sum_p521_kernel, xs, ys, zs, ox, oy, oz, n, stream);
}
