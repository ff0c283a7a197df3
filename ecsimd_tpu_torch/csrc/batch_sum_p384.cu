// Kernel M, the batch reduction tree of multi-scalar multiplication, on
// P-384, a whole tree (or its first levels) in one cooperative launch
// (NVIDIA Hopper, sm_90a): batch_sum_lane.cuh over the curve's formulas on
// the P-384 field (field_p384.cuh, 12 32-bit words, the multiplies
// called). batch_sum.cu says what the kernel computes and what bounds it.
// One source a curve, so that the builds run side by side. Replaces
// ecsimd_tpu/curves/group.py:batch_sum (plain XLA, no Pallas kernel).

#include "batch_sum_kernel.cuh"
#include "coz_p384.cuh"

namespace p384 {
#include "batch_sum_lane.cuh"
}  // namespace p384

// Block 0's levels in shared memory (true) or in the L2 scratch (false),
// a curve, by measurement (PERF.md).
EC_BATCH_SUM_KERNEL(p384, p384, false)

// xs, ys, zs: (24, n) Jacobian planes in the field's internal form; ox,
// oy, oz: the (24, m) planes left after `levels` levels; scratch and the
// rest: batch_sum_kernel.cuh's launch. Returns the launch's CUDA error.
extern "C" int ec_batch_sum_p384(const int32_t* xs, const int32_t* ys, const int32_t* zs,
                                 int32_t* ox, int32_t* oy, int32_t* oz, int32_t* scratch,
                                 int64_t n, int64_t levels, void* stream) {
  return batch_sum::launch(batch_sum_p384_kernel, blocks_p384, xs, ys, zs, ox,
                           oy, oz, scratch, n, levels, stream);
}

// The blocks of batch_sum::kThreads threads an SM holds (or minus the CUDA
// error).
extern "C" int ec_batch_sum_p384_blocks(void) {
  return batch_sum::blocks_per_sm(batch_sum_p384_kernel, blocks_p384);
}
