// Kernel M: one level of the batch reduction tree of multi-scalar
// multiplication on P-256, secp256k1 and Wei25519, one output lane per
// thread (NVIDIA Hopper, sm_90a).
//
// Replaces ecsimd_tpu/curves/group.py:batch_sum, which the JAX package runs
// as plain XLA (no Pallas kernel): log2 B levels, each adding lane i to lane
// i + n / 2 with the exception-free complete add and carrying an odd last
// lane (batch_sum_lane.cuh). In plain PyTorch each level is ~30 field
// operations of many small launches each, for work the card does in
// microseconds; here a level is one launch. Inputs and outputs are
// Jacobian planes in the field's internal form (Montgomery form on
// secp256k1), bit-identical to the plain PyTorch version.
//
// What bounds it: the first levels move the batch's planes once (bytes);
// the last levels hold a handful of lanes, so each is one lane's latency
// through a complete add plus a launch.

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

#include "batch_sum_kernel.cuh"

namespace {

EC_BATCH_SUM_KERNEL(batch_sum_p256_kernel, p256)
EC_BATCH_SUM_KERNEL(batch_sum_secp256k1_kernel, secp256k1)
EC_BATCH_SUM_KERNEL(batch_sum_w25519_kernel, w25519)

}  // namespace

// xs, ys, zs: (16, n) Jacobian planes in the field's internal form; ox, oy,
// oz: (16, (n + 1) / 2) outputs. Launches on `stream` and returns
// cudaGetLastError().
extern "C" int ec_batch_sum_p256(const int32_t* xs, const int32_t* ys, const int32_t* zs,
                                 int32_t* ox, int32_t* oy, int32_t* oz, int64_t n,
                                 void* stream) {
  return batch_sum::launch(batch_sum_p256_kernel, xs, ys, zs, ox, oy, oz, n, stream);
}

extern "C" int ec_batch_sum_secp256k1(const int32_t* xs, const int32_t* ys, const int32_t* zs,
                                      int32_t* ox, int32_t* oy, int32_t* oz, int64_t n,
                                      void* stream) {
  return batch_sum::launch(batch_sum_secp256k1_kernel, xs, ys, zs, ox, oy, oz, n, stream);
}

extern "C" int ec_batch_sum_w25519(const int32_t* xs, const int32_t* ys, const int32_t* zs,
                                   int32_t* ox, int32_t* oy, int32_t* oz, int64_t n,
                                   void* stream) {
  return batch_sum::launch(batch_sum_w25519_kernel, xs, ys, zs, ox, oy, oz, n, stream);
}
