// Kernel L, generic, on P-384, plain and strict, one lane per thread (NVIDIA
// Hopper, sm_90a): comb_general_lane.cuh's walk over the P-384 field
// (field_p384.cuh, 12 32-bit words) and comb_general.cuh's launcher, which
// say what the kernel computes, how it stays constant-time and what bounds
// it. Here npos = 48.
// 128 threads a block; its field multiplies are calls, not inlined
// (field_p384.cuh).
// Replaces ecsimd_tpu/kernels/comb.py:_comb_kernel with chains > 1 or
// unroll > 1.

#include "coz_p384.cuh"
#include "comb_general.cuh"

namespace p384 {
#include "comb_lane.cuh"
#include "comb_mma_lane.cuh"
#include "comb_general_lane.cuh"
}  // namespace p384

namespace {
EC_COMB_GENERAL_KERNEL(comb_general_p384_kernel, p384, false, 1)
EC_COMB_GENERAL_KERNEL(comb_general_strict_p384_kernel, p384, true, 1)
}  // namespace

// scalars: (24, B) int32 digit planes; tables: 6272 x 96 bytes
// (kernels/comb.mma_layout), 16-byte aligned; negbase: 48 int32 digits (x
// then y) of -B, internal form; ax, ay, z: (24, B) outputs; chains, unroll: the
// schedule (48 a multiple of chains * unroll; strict: one chain). Launches
// on `stream` and returns cudaGetLastError(); <entry>_smem returns the dynamic
// shared memory its last launch asked for (smem_granted), <entry>_blocks the
// blocks an SM holds at that size (blocks_granted).
extern "C" int ec_comb_general_p384(const int32_t* scalars, const uint8_t* tables,
                                    const int32_t* negbase, int32_t* ax, int32_t* ay, int32_t* z,
                                    int64_t B, int64_t chains, int64_t unroll, void* stream) {
  return launch_general<p384::kWords, p384::kCombPositions>(
      comb_general_p384_kernel, false, scalars, tables, negbase, ax, ay, z, B, chains, unroll,
      stream);
}

extern "C" int ec_comb_general_p384_strict(const int32_t* scalars, const uint8_t* tables,
                                           const int32_t* negbase, int32_t* ax, int32_t* ay,
                                           int32_t* z, int64_t B, int64_t chains,
                                           int64_t unroll, void* stream) {
  return launch_general<p384::kWords, p384::kCombPositions>(
      comb_general_strict_p384_kernel, true, scalars, tables, negbase, ax, ay, z, B, chains,
      unroll, stream);
}

extern "C" int ec_comb_general_p384_smem(void) { return smem_granted(comb_general_p384_kernel); }
extern "C" int ec_comb_general_p384_blocks(void) {
  return blocks_granted(comb_general_p384_kernel, comb::kThreads);
}
extern "C" int ec_comb_general_p384_strict_smem(void) {
  return smem_granted(comb_general_strict_p384_kernel);
}
extern "C" int ec_comb_general_p384_strict_blocks(void) {
  return blocks_granted(comb_general_strict_p384_kernel, comb::kThreads);
}
