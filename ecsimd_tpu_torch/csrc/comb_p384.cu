// Kernel B: fixed-base comb k_i * B on P-384, plain and strict, one lane
// per thread (NVIDIA Hopper, sm_90a): comb_mma_lane.cuh's chain over the
// P-384 field (12 32-bit words, field_p384.cuh), launched by comb_mma.cuh.
// comb.cu says what the kernel computes and what bounds it, comb_mma.cuh
// how it selects an entry and stays constant-time; here the chain has npos
// = nbits / 8 = 48 positions, an entry is 96 bytes (the x then the y
// limbs, 12 n-tiles of the product), position 0 is 24 KiB and each
// other 12 KiB, the whole table 6,272 entries, 588 KiB, read from L2. Its field
// multiplies are calls, not inlined (field_p384.cuh). One source a curve, so
// that the builds run side by side. Replaces
// ecsimd_tpu/kernels/comb.py:_comb_kernel (serial chain, unroll 1, both
// strict variants).

#include "coz_p384.cuh"
#include "comb_mma.cuh"

namespace p384 {
#include "comb_lane.cuh"
#include "comb_mma_lane.cuh"
}  // namespace p384

namespace {
EC_COMB_MMA_KERNEL(comb_p384_kernel, p384, false)
EC_COMB_MMA_KERNEL(comb_strict_p384_kernel, p384, true)
}  // namespace

// scalars: (24, B) int32 digit planes; tables: 6272 x 96 bytes
// (kernels/comb.mma_layout), 16-byte aligned; negbase: 48 int32 digits (x
// then y) of -B; ax, ay, z: (24, B) outputs. Launches on `stream` and returns
// cudaGetLastError(); <entry>_smem returns the dynamic shared memory a
// block is given (smem_granted), <entry>_blocks the blocks an SM holds
// (blocks_granted).
extern "C" int ec_comb_p384(const int32_t* scalars, const uint8_t* tables,
                            const int32_t* negbase, int32_t* ax, int32_t* ay, int32_t* z,
                            int64_t B, void* stream) {
  return launch_serial<p384::kWords>(comb_p384_kernel, scalars, tables, negbase, ax, ay, z,
                                     B, stream);
}

extern "C" int ec_comb_p384_strict(const int32_t* scalars, const uint8_t* tables,
                                   const int32_t* negbase, int32_t* ax, int32_t* ay, int32_t* z,
                                   int64_t B, void* stream) {
  return launch_serial<p384::kWords>(comb_strict_p384_kernel, scalars, tables, negbase, ax, ay,
                                     z, B, stream);
}

extern "C" int ec_comb_p384_smem(void) { return smem_granted(comb_p384_kernel); }
extern "C" int ec_comb_p384_blocks(void) {
  return blocks_granted(comb_p384_kernel, comb::kThreads);
}
extern "C" int ec_comb_p384_strict_smem(void) { return smem_granted(comb_strict_p384_kernel); }
extern "C" int ec_comb_p384_strict_blocks(void) {
  return blocks_granted(comb_strict_p384_kernel, comb::kThreads);
}
