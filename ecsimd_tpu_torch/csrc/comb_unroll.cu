// Kernel L with one chain, unroll 2 and 4, plain and strict, on P-256
// (NVIDIA Hopper, sm_90a): the C entry points of the instantiations of
// comb_chains.cuh, which says what the kernel computes and how; the
// Jacobian planes are kernel B's (B strict's) bit for bit. Replaces
// ecsimd_tpu/kernels/comb.py:_comb_kernel with chains == 1, unroll > 1.

#include "comb_chains.cuh"

// Each entry: scalars (16, B) int32 digit planes; tables (4224, 16) int32
// limbs, 16-byte aligned; negbase 32 int32 digits (x then y) of -B; ax, ay,
// z (16, B) outputs. Launches on `stream` and returns cudaGetLastError();
// <entry>_smem returns the dynamic shared memory of its block (smem_granted).
extern "C" int ec_comb_chains_p256_c1u2(const int32_t* scalars, const int32_t* tables,
                                        const int32_t* negbase, int32_t* ax, int32_t* ay,
                                        int32_t* z, int64_t B, void* stream) {
  return launch<1, 2, false>(scalars, tables, negbase, ax, ay, z, B, stream);
}

extern "C" int ec_comb_chains_p256_c1u4(const int32_t* scalars, const int32_t* tables,
                                        const int32_t* negbase, int32_t* ax, int32_t* ay,
                                        int32_t* z, int64_t B, void* stream) {
  return launch<1, 4, false>(scalars, tables, negbase, ax, ay, z, B, stream);
}

extern "C" int ec_comb_chains_p256_c1u2_strict(const int32_t* scalars, const int32_t* tables,
                                               const int32_t* negbase, int32_t* ax, int32_t* ay,
                                               int32_t* z, int64_t B, void* stream) {
  return launch<1, 2, true>(scalars, tables, negbase, ax, ay, z, B, stream);
}

extern "C" int ec_comb_chains_p256_c1u4_strict(const int32_t* scalars, const int32_t* tables,
                                               const int32_t* negbase, int32_t* ax, int32_t* ay,
                                               int32_t* z, int64_t B, void* stream) {
  return launch<1, 4, true>(scalars, tables, negbase, ax, ay, z, B, stream);
}

extern "C" int ec_comb_chains_p256_c1u2_smem(void) { return smem_granted<1, 2, false>(); }
extern "C" int ec_comb_chains_p256_c1u4_smem(void) { return smem_granted<1, 4, false>(); }
extern "C" int ec_comb_chains_p256_c1u2_strict_smem(void) { return smem_granted<1, 2, true>(); }
extern "C" int ec_comb_chains_p256_c1u4_strict_smem(void) { return smem_granted<1, 4, true>(); }
