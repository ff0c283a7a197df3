// Kernel L with chains 2 and 4 (unroll 1 and 2 with two chains) on P-256
// (NVIDIA Hopper, sm_90a): the C entry points of the instantiations of
// comb_chains.cuh's kernel over comb_chains_lane.cuh, which say what the
// kernel computes and how. Replaces ecsimd_tpu/kernels/comb.py:_comb_kernel
// with chains > 1.

#include "coz_p256.cuh"
#include "comb_chains.cuh"

namespace p256 {
#include "comb_lane.cuh"
#include "comb_chains_lane.cuh"
}  // namespace p256

namespace {
EC_COMB_CHAINS_KERNEL(p256)
}  // namespace

// Each entry: scalars (16, B) int32 digit planes; tables (4224, 16) int32
// limbs, 16-byte aligned; negbase 32 int32 digits (x then y) of -B, internal
// form; ax, ay, z (16, B) outputs. Launches on `stream` and returns
// cudaGetLastError(); <entry>_smem returns the dynamic shared memory of its
// block (smem_granted).
extern "C" int ec_comb_chains_p256_c2u1(const int32_t* scalars, const int32_t* tables,
                                        const int32_t* negbase, int32_t* ax, int32_t* ay,
                                        int32_t* z, int64_t B, void* stream) {
  return launch<2, 1>(comb_chains_p256_kernel<2, 1, false>,
                      scalars, tables, negbase, ax, ay, z, B, stream);
}

extern "C" int ec_comb_chains_p256_c2u2(const int32_t* scalars, const int32_t* tables,
                                        const int32_t* negbase, int32_t* ax, int32_t* ay,
                                        int32_t* z, int64_t B, void* stream) {
  return launch<2, 2>(comb_chains_p256_kernel<2, 2, false>,
                      scalars, tables, negbase, ax, ay, z, B, stream);
}

extern "C" int ec_comb_chains_p256_c4u1(const int32_t* scalars, const int32_t* tables,
                                        const int32_t* negbase, int32_t* ax, int32_t* ay,
                                        int32_t* z, int64_t B, void* stream) {
  return launch<4, 1>(comb_chains_p256_kernel<4, 1, false>,
                      scalars, tables, negbase, ax, ay, z, B, stream);
}

extern "C" int ec_comb_chains_p256_c2u1_smem(void) {
  return smem_granted(comb_chains_p256_kernel<2, 1, false>);
}
extern "C" int ec_comb_chains_p256_c2u2_smem(void) {
  return smem_granted(comb_chains_p256_kernel<2, 2, false>);
}
extern "C" int ec_comb_chains_p256_c4u1_smem(void) {
  return smem_granted(comb_chains_p256_kernel<4, 1, false>);
}
