// Kernel L, generic, on Wei25519, plain and strict, one lane per thread (NVIDIA
// Hopper, sm_90a): comb_general_lane.cuh's walk over the Wei25519 field
// (field_w25519.cuh, 8 32-bit words) and comb_general.cuh's launcher, which
// say what the kernel computes, how it stays constant-time and what bounds
// it. Here npos = 32.
// 128 threads a block, three blocks an SM asked of ptxas (the most that
// four staged positions and the row buffers, 74 KiB, let in).
// Replaces ecsimd_tpu/kernels/comb.py:_comb_kernel with chains > 1 or
// unroll > 1.

#include "coz_w25519.cuh"
#include "comb_general.cuh"

namespace w25519 {
#include "comb_lane.cuh"
#include "comb_mma_lane.cuh"
#include "comb_general_lane.cuh"
}  // namespace w25519

namespace {
EC_COMB_GENERAL_KERNEL(comb_general_w25519_kernel, w25519, false, 3)
EC_COMB_GENERAL_KERNEL(comb_general_strict_w25519_kernel, w25519, true, 3)
}  // namespace

// scalars: (16, B) int32 digit planes; tables: 4224 x 64 bytes
// (kernels/comb.mma_layout), 16-byte aligned; negbase: 32 int32 digits (x
// then y) of -B, internal form; ax, ay, z: (16, B) outputs; chains, unroll: the
// schedule (32 a multiple of chains * unroll; strict: one chain). Launches
// on `stream` and returns cudaGetLastError(); <entry>_smem returns the dynamic
// shared memory its last launch asked for (smem_granted), <entry>_blocks the
// blocks an SM holds at that size (blocks_granted).
extern "C" int ec_comb_general_w25519(const int32_t* scalars, const uint8_t* tables,
                                    const int32_t* negbase, int32_t* ax, int32_t* ay, int32_t* z,
                                    int64_t B, int64_t chains, int64_t unroll, void* stream) {
  return launch_general<w25519::kWords, w25519::kCombPositions>(
      comb_general_w25519_kernel, false, scalars, tables, negbase, ax, ay, z, B, chains, unroll,
      stream);
}

extern "C" int ec_comb_general_w25519_strict(const int32_t* scalars, const uint8_t* tables,
                                           const int32_t* negbase, int32_t* ax, int32_t* ay,
                                           int32_t* z, int64_t B, int64_t chains,
                                           int64_t unroll, void* stream) {
  return launch_general<w25519::kWords, w25519::kCombPositions>(
      comb_general_strict_w25519_kernel, true, scalars, tables, negbase, ax, ay, z, B, chains,
      unroll, stream);
}

extern "C" int ec_comb_general_w25519_smem(void) {
  return smem_granted(comb_general_w25519_kernel);
}
extern "C" int ec_comb_general_w25519_blocks(void) {
  return blocks_granted(comb_general_w25519_kernel, comb::kThreads);
}
extern "C" int ec_comb_general_w25519_strict_smem(void) {
  return smem_granted(comb_general_strict_w25519_kernel);
}
extern "C" int ec_comb_general_w25519_strict_blocks(void) {
  return blocks_granted(comb_general_strict_w25519_kernel, comb::kThreads);
}
