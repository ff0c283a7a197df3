// Kernel M: the batch reduction tree of multi-scalar multiplication on
// P-256, secp256k1 and Wei25519, a whole tree (or its first levels) in one
// cooperative launch (NVIDIA Hopper, sm_90a).
//
// Replaces ecsimd_tpu/curves/group.py:batch_sum, which the JAX package runs
// as plain XLA (no Pallas kernel): log2 B levels, each adding lane i to lane
// i + n / 2 with the exception-free complete add and carrying an odd last
// lane (batch_sum_lane.cuh). In plain PyTorch each level is ~30 field
// operations of many small launches each, for work the card does in
// microseconds. Inputs and outputs are Jacobian planes in the field's
// internal form (Montgomery form on secp256k1), bit-identical to the plain
// PyTorch version.
//
// What bounds it: the first levels move the batch's planes once and do
// most of the adds (operations); the last 16 levels hold fewer lanes than
// the card holds threads, so each is one lane's latency through a complete
// add. One launch a tree takes the host out of that chain: the grid sync
// separates the levels while they fill the card, and block 0 alone does
// the levels that fit one block, with __syncthreads (batch_sum_lane.cuh's
// batch_sum_tree). Measured (PERF.md): with block 0's levels in shared
// memory (P-256, Wei25519) the grid's levels run as fast a lane as one
// launch a level did; the one loop that serves both phases where they stay
// in the scratch (secp256k1 here) runs the first levels ~1.3x slower, for
// reasons not yet known, but its shared-memory twin spilled and ran slower.

#include "batch_sum_kernel.cuh"
#include "coz_p256.cuh"
#include "coz_secp256k1.cuh"
#include "coz_w25519.cuh"

namespace p256 {
#include "batch_sum_lane.cuh"
}  // namespace p256

namespace secp256k1 {
#include "batch_sum_lane.cuh"
}  // namespace secp256k1

namespace w25519 {
#include "batch_sum_lane.cuh"
}  // namespace w25519

// Block 0's levels in shared memory (true) or in the L2 scratch (false),
// a curve, by measurement (PERF.md).
EC_BATCH_SUM_KERNEL(p256, p256, true)
EC_BATCH_SUM_KERNEL(secp256k1, secp256k1, false)
EC_BATCH_SUM_KERNEL(w25519, w25519, true)

// xs, ys, zs: (16, n) Jacobian planes in the field's internal form; ox,
// oy, oz: the (16, m) planes left after `levels` levels; scratch and the
// rest: batch_sum_kernel.cuh's launch. Returns the launch's CUDA error.
extern "C" int ec_batch_sum_p256(const int32_t* xs, const int32_t* ys, const int32_t* zs,
                                 int32_t* ox, int32_t* oy, int32_t* oz, int32_t* scratch,
                                 int64_t n, int64_t levels, void* stream) {
  return batch_sum::launch(batch_sum_p256_kernel, blocks_p256, xs, ys, zs, ox,
                           oy, oz, scratch, n, levels, stream);
}

// The blocks of batch_sum::kThreads threads an SM holds (or minus the CUDA
// error).
extern "C" int ec_batch_sum_p256_blocks(void) {
  return batch_sum::blocks_per_sm(batch_sum_p256_kernel, blocks_p256);
}

// xs, ys, zs: (16, n) Jacobian planes in the field's internal form; ox,
// oy, oz: the (16, m) planes left after `levels` levels; scratch and the
// rest: batch_sum_kernel.cuh's launch. Returns the launch's CUDA error.
extern "C" int ec_batch_sum_secp256k1(const int32_t* xs, const int32_t* ys, const int32_t* zs,
                                      int32_t* ox, int32_t* oy, int32_t* oz, int32_t* scratch,
                                      int64_t n, int64_t levels, void* stream) {
  return batch_sum::launch(batch_sum_secp256k1_kernel, blocks_secp256k1, xs, ys, zs, ox,
                           oy, oz, scratch, n, levels, stream);
}

// The blocks of batch_sum::kThreads threads an SM holds (or minus the CUDA
// error).
extern "C" int ec_batch_sum_secp256k1_blocks(void) {
  return batch_sum::blocks_per_sm(batch_sum_secp256k1_kernel, blocks_secp256k1);
}

// xs, ys, zs: (16, n) Jacobian planes in the field's internal form; ox,
// oy, oz: the (16, m) planes left after `levels` levels; scratch and the
// rest: batch_sum_kernel.cuh's launch. Returns the launch's CUDA error.
extern "C" int ec_batch_sum_w25519(const int32_t* xs, const int32_t* ys, const int32_t* zs,
                                   int32_t* ox, int32_t* oy, int32_t* oz, int32_t* scratch,
                                   int64_t n, int64_t levels, void* stream) {
  return batch_sum::launch(batch_sum_w25519_kernel, blocks_w25519, xs, ys, zs, ox,
                           oy, oz, scratch, n, levels, stream);
}

// The blocks of batch_sum::kThreads threads an SM holds (or minus the CUDA
// error).
extern "C" int ec_batch_sum_w25519_blocks(void) {
  return batch_sum::blocks_per_sm(batch_sum_w25519_kernel, blocks_w25519);
}
