// Kernel B: fixed-base comb k_i * B on P-384, plain and strict, one lane
// per thread (NVIDIA Hopper, sm_90a): comb_lane.cuh's chain over the
// P-384 field (12 32-bit words, field_p384.cuh), launched by comb_wide.cuh.
// comb.cu says what the kernel computes, how it stays constant-time and
// what bounds it; here the chain has npos = nbits / 8 = 48 positions, an
// entry is 6 16-byte vectors (the x then the y limbs, each padded to whole
// vectors), position 0 is 24 KiB and each other 12 KiB, the whole table
// 6,272 entries, 588 KiB, read from L2. Its field multiplies are calls,
// not inlined (field_p384.cuh). One source a curve, so that the builds run
// side by side. Replaces ecsimd_tpu/kernels/comb.py:_comb_kernel (serial
// chain, unroll 1, both strict variants).

#include "coz_p384.cuh"
#include "comb_wide.cuh"

namespace p384 {
#include "comb_lane.cuh"
}  // namespace p384

namespace {
EC_COMB_WIDE_KERNEL(comb_p384_kernel, p384, false)
EC_COMB_WIDE_KERNEL(comb_strict_p384_kernel, p384, true)
}  // namespace

// scalars: (24, B) int32 digit planes; tables: (6272, 24) int32 limbs
// (kernels/comb.kernel_tables), 16-byte aligned; negbase: 48 int32 digits (x
// then y) of -B; ax, ay, z: (24, B) outputs. Launches on `stream` and returns
// cudaGetLastError().
extern "C" int ec_comb_p384(const int32_t* scalars, const int32_t* tables,
                            const int32_t* negbase, int32_t* ax, int32_t* ay, int32_t* z,
                            int64_t B, void* stream) {
  return launch_wide<p384::kWords>(comb_p384_kernel, scalars, tables, negbase, ax, ay, z, B,
                                  stream);
}

extern "C" int ec_comb_p384_strict(const int32_t* scalars, const int32_t* tables,
                                   const int32_t* negbase, int32_t* ax, int32_t* ay, int32_t* z,
                                   int64_t B, void* stream) {
  return launch_wide<p384::kWords>(comb_strict_p384_kernel, scalars, tables, negbase, ax, ay, z,
                                  B, stream);
}

extern "C" int ec_comb_p384_smem(void) { return smem_granted(comb_p384_kernel); }
extern "C" int ec_comb_p384_strict_smem(void) {
  return smem_granted(comb_strict_p384_kernel);
}
