// Kernel B: fixed-base comb k_i * B on P-521, plain and strict, one lane
// per thread (NVIDIA Hopper, sm_90a): comb_lane.cuh's chain over the
// P-521 field (17 32-bit words, field_p521.cuh), launched by comb_wide.cuh.
// comb.cu says what the kernel computes, how it stays constant-time and
// what bounds it; here the chain has npos = nbits / 8 = 66 positions, an
// entry is 10 16-byte vectors (the x then the y limbs, each padded to whole
// vectors), position 0 is 40 KiB and each other 20 KiB, the whole table
// 8,576 entries, 1,340 KiB, read from L2. Its field multiplies are calls,
// not inlined (field_p521.cuh). One source a curve, so that the builds run
// side by side. Replaces ecsimd_tpu/kernels/comb.py:_comb_kernel (serial
// chain, unroll 1, both strict variants).

#include "coz_p521.cuh"
#include "comb_wide.cuh"

namespace p521 {
#include "comb_lane.cuh"
}  // namespace p521

namespace {
EC_COMB_WIDE_KERNEL(comb_p521_kernel, p521, false)
EC_COMB_WIDE_KERNEL(comb_strict_p521_kernel, p521, true)
}  // namespace

// scalars: (33, B) int32 digit planes; tables: (8576, 40) int32 limbs
// (kernels/comb.kernel_tables), 16-byte aligned; negbase: 66 int32 digits (x
// then y) of -B; ax, ay, z: (33, B) outputs. Launches on `stream` and returns
// cudaGetLastError().
extern "C" int ec_comb_p521(const int32_t* scalars, const int32_t* tables,
                            const int32_t* negbase, int32_t* ax, int32_t* ay, int32_t* z,
                            int64_t B, void* stream) {
  return launch_wide<p521::kWords>(comb_p521_kernel, scalars, tables, negbase, ax, ay, z, B,
                                  stream);
}

extern "C" int ec_comb_p521_strict(const int32_t* scalars, const int32_t* tables,
                                   const int32_t* negbase, int32_t* ax, int32_t* ay, int32_t* z,
                                   int64_t B, void* stream) {
  return launch_wide<p521::kWords>(comb_strict_p521_kernel, scalars, tables, negbase, ax, ay, z,
                                  B, stream);
}

extern "C" int ec_comb_p521_smem(void) { return smem_granted(comb_p521_kernel); }
extern "C" int ec_comb_p521_strict_smem(void) {
  return smem_granted(comb_strict_p521_kernel);
}
