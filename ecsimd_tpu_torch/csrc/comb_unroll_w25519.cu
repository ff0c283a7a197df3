// Kernel L with one chain, unroll 2 and 4, plain and strict, on Wei25519
// (NVIDIA Hopper, sm_90a): the C entry points of the instantiations of
// comb_chains.cuh's kernel over comb_chains_lane.cuh, which say what the
// kernel computes and how. The Jacobian planes are kernel B's (B strict's) bit
// for bit. Replaces ecsimd_tpu/kernels/comb.py:_comb_kernel with chains == 1,
// unroll > 1.

#include "coz_w25519.cuh"
#include "comb_chains.cuh"

namespace w25519 {
#include "comb_lane.cuh"
#include "comb_chains_lane.cuh"
}  // namespace w25519

namespace {
EC_COMB_CHAINS_KERNEL(w25519)
}  // namespace

// Each entry: scalars (16, B) int32 digit planes; tables (4224, 16) int32
// limbs, 16-byte aligned; negbase 32 int32 digits (x then y) of -B, internal
// form; ax, ay, z (16, B) outputs. Launches on `stream` and returns
// cudaGetLastError(); <entry>_smem returns the dynamic shared memory of its
// block (smem_granted).
extern "C" int ec_comb_chains_w25519_c1u2(const int32_t* scalars, const int32_t* tables,
                                          const int32_t* negbase, int32_t* ax, int32_t* ay,
                                          int32_t* z, int64_t B, void* stream) {
  return launch<1, 2>(comb_chains_w25519_kernel<1, 2, false>,
                      scalars, tables, negbase, ax, ay, z, B, stream);
}

extern "C" int ec_comb_chains_w25519_c1u4(const int32_t* scalars, const int32_t* tables,
                                          const int32_t* negbase, int32_t* ax, int32_t* ay,
                                          int32_t* z, int64_t B, void* stream) {
  return launch<1, 4>(comb_chains_w25519_kernel<1, 4, false>,
                      scalars, tables, negbase, ax, ay, z, B, stream);
}

extern "C" int ec_comb_chains_w25519_c1u2_strict(const int32_t* scalars, const int32_t* tables,
                                                 const int32_t* negbase, int32_t* ax, int32_t* ay,
                                                 int32_t* z, int64_t B, void* stream) {
  return launch<1, 2>(comb_chains_w25519_kernel<1, 2, true>,
                      scalars, tables, negbase, ax, ay, z, B, stream);
}

extern "C" int ec_comb_chains_w25519_c1u4_strict(const int32_t* scalars, const int32_t* tables,
                                                 const int32_t* negbase, int32_t* ax, int32_t* ay,
                                                 int32_t* z, int64_t B, void* stream) {
  return launch<1, 4>(comb_chains_w25519_kernel<1, 4, true>,
                      scalars, tables, negbase, ax, ay, z, B, stream);
}

extern "C" int ec_comb_chains_w25519_c1u2_smem(void) {
  return smem_granted(comb_chains_w25519_kernel<1, 2, false>);
}
extern "C" int ec_comb_chains_w25519_c1u4_smem(void) {
  return smem_granted(comb_chains_w25519_kernel<1, 4, false>);
}
extern "C" int ec_comb_chains_w25519_c1u2_strict_smem(void) {
  return smem_granted(comb_chains_w25519_kernel<1, 2, true>);
}
extern "C" int ec_comb_chains_w25519_c1u4_strict_smem(void) {
  return smem_granted(comb_chains_w25519_kernel<1, 4, true>);
}
