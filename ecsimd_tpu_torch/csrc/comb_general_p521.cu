// Kernel L, generic, on P-521, plain and strict, one lane per thread (NVIDIA
// Hopper, sm_90a): comb_general_lane.cuh's walk over the P-521 field
// (field_p521.cuh, 17 32-bit words) and comb_general.cuh's launcher, which
// say what the kernel computes, how it stays constant-time and what bounds
// it. Here npos = 66.
// 128 threads a block; its field multiplies are calls, not inlined
// (field_p521.cuh).
// Replaces ecsimd_tpu/kernels/comb.py:_comb_kernel with chains > 1 or
// unroll > 1.

#include "coz_p521.cuh"
#include "comb_general.cuh"

namespace p521 {
#include "comb_lane.cuh"
#include "comb_mma_lane.cuh"
#include "comb_general_lane.cuh"
}  // namespace p521

namespace {
EC_COMB_GENERAL_KERNEL(comb_general_p521_kernel, p521, false, 1)
EC_COMB_GENERAL_KERNEL(comb_general_strict_p521_kernel, p521, true, 1)
}  // namespace

// scalars: (33, B) int32 digit planes; tables: 8576 x 136 bytes
// (kernels/comb.mma_layout), 16-byte aligned; negbase: 66 int32 digits (x
// then y) of -B, internal form; ax, ay, z: (33, B) outputs; chains, unroll: the
// schedule (66 a multiple of chains * unroll; strict: one chain). Launches
// on `stream` and returns cudaGetLastError(); <entry>_smem returns the dynamic
// shared memory its last launch asked for (smem_granted), <entry>_blocks the
// blocks an SM holds at that size (blocks_granted).
extern "C" int ec_comb_general_p521(const int32_t* scalars, const uint8_t* tables,
                                    const int32_t* negbase, int32_t* ax, int32_t* ay, int32_t* z,
                                    int64_t B, int64_t chains, int64_t unroll, void* stream) {
  return launch_general<p521::kWords, p521::kCombPositions>(
      comb_general_p521_kernel, false, scalars, tables, negbase, ax, ay, z, B, chains, unroll,
      stream);
}

extern "C" int ec_comb_general_p521_strict(const int32_t* scalars, const uint8_t* tables,
                                           const int32_t* negbase, int32_t* ax, int32_t* ay,
                                           int32_t* z, int64_t B, int64_t chains,
                                           int64_t unroll, void* stream) {
  return launch_general<p521::kWords, p521::kCombPositions>(
      comb_general_strict_p521_kernel, true, scalars, tables, negbase, ax, ay, z, B, chains,
      unroll, stream);
}

extern "C" int ec_comb_general_p521_smem(void) { return smem_granted(comb_general_p521_kernel); }
extern "C" int ec_comb_general_p521_blocks(void) {
  return blocks_granted(comb_general_p521_kernel, comb::kThreads);
}
extern "C" int ec_comb_general_p521_strict_smem(void) {
  return smem_granted(comb_general_strict_p521_kernel);
}
extern "C" int ec_comb_general_p521_strict_blocks(void) {
  return blocks_granted(comb_general_strict_p521_kernel, comb::kThreads);
}
