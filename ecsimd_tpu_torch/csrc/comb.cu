// Kernel B: fixed-base comb k_i * B on P-256, secp256k1 and Wei25519 (X25519
// keygen), plain and strict, one lane per thread (NVIDIA Hopper, sm_90a).
//
// Replaces ecsimd_tpu/kernels/comb.py:_comb_kernel (serial chain, one
// accumulator, unroll 1), both strict variants. Width-8 signed-odd comb
// with no doublings: the entry index of position j is e_j = w9_j >> 1,
// where w9_j is the 9-bit window k[8j .. 8j+8]; the accumulator seeds from
// position 0's entry with z = 1 (the recoding's top digit is folded into
// that table), positions 1..31 each add one entry with ADD_Z2_1, and even
// scalars get -B added at the end (k was computed as k + 1). Strict
// (ec_comb_*_strict): every add, the fix-up included, is add_complete
// against the entry with z = 1, so prefix sums that hit an entry, its
// opposite or infinity stay right, and k = n - 1 gives -B. Same order as
// kernels/comb.comb_plain, so the Jacobian planes agree bit for bit
// (Montgomery form on secp256k1, as the JAX package keeps it). Wei25519's
// 2^255 - 19 field has the same 16-digit layout (nbits = 256), so
// entry_index and the negbase offset hold for it unchanged; its clamped
// scalars (near 2^254, above the order) take the same chain.
//
// Constant time, memory accesses included: no address depends on the
// scalar. The TPU kernel reads every entry of a position through a one-hot
// product on its matrix unit; here the block stages each position's table
// in shared memory and every thread scans every entry with masks (the
// window kernel's table_get, at the comb's size). The scan is a broadcast:
// all threads of a warp read the same 16 bytes at once, without bank
// conflicts.
//
// Tables (kernels/comb.kernel_tables): int32 (4224, 16) — per entry the 8
// x-limbs then the 8 y-limbs of an affine point, 32-bit limbs in the
// field's internal form. Position 0 keeps its 256 signed entries (the top
// digit folded in makes them not pairwise opposite); positions 1..31 keep
// only the 128 positive entries (2m+1) 2^(8j) B and the sign is applied by
// a masked negation of y. So a position is 2,048 words (4,096 for position
// 0), 270 KiB in all, read from L2 into shared memory by cp.async, double
// buffered: position j+1 is in flight while the lanes add position j.
//
// What bounds it: the masked scan, ~68 K shared-memory words per lane (one
// 16-byte broadcast load and four masked ORs per 4 words), beside the
// chain's 32-bit multiply-adds (31 + 1 mixed adds of 7 field multiplies
// and 4 squarings; strict: complete adds of 15 + 9 on P-256, 13 + 11 on
// secp256k1, 14 + 12 on Wei25519).

#include "coz_p256.cuh"
#include "coz_secp256k1.cuh"
#include "coz_w25519.cuh"
#include "comb_scan.cuh"

namespace p256 {
#include "comb_lane.cuh"
}  // namespace p256

namespace secp256k1 {
#include "comb_lane.cuh"
}  // namespace secp256k1

namespace w25519 {
#include "comb_lane.cuh"
}  // namespace w25519

namespace {

using comb::kThreads;

// Lanes past the end of the batch run the chain on the last lane and store
// nothing: every thread takes part in the block's staging and barriers.
#define EC_COMB_KERNEL(NAME, NS, STRICT)                                                   \
  __global__ void __launch_bounds__(kThreads)                                              \
  NAME(const int32_t* __restrict__ scalars, const uint4* __restrict__ tables,              \
       const int32_t* __restrict__ negbase, int32_t* __restrict__ ax,                      \
       int32_t* __restrict__ ay, int32_t* __restrict__ z, int64_t B) {                     \
    __shared__ uint4 buf[2][comb::kBufVecs];                                               \
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;                      \
    NS::comb_lane<STRICT>(scalars, tables, negbase, ax, ay, z, B, i < B ? i : B - 1,       \
                          i < B, buf);                                                     \
  }

EC_COMB_KERNEL(comb_p256_kernel, p256, false)
EC_COMB_KERNEL(comb_strict_p256_kernel, p256, true)
EC_COMB_KERNEL(comb_secp256k1_kernel, secp256k1, false)
EC_COMB_KERNEL(comb_strict_secp256k1_kernel, secp256k1, true)
EC_COMB_KERNEL(comb_w25519_kernel, w25519, false)
EC_COMB_KERNEL(comb_strict_w25519_kernel, w25519, true)

template <class Kernel>
int launch(Kernel kernel, const int32_t* scalars, const int32_t* tables, const int32_t* negbase,
           int32_t* ax, int32_t* ay, int32_t* z, int64_t B, void* stream) {
  if (B > 0) {
    const int64_t blocks = (B + kThreads - 1) / kThreads;
    kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        scalars, reinterpret_cast<const uint4*>(tables), negbase, ax, ay, z, B);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// scalars: (16, B) int32 digit planes; tables: (4224, 16) int32 limbs,
// 16-byte aligned; negbase: 32 int32 digits (x then y) of -B, internal form;
// ax, ay, z: (16, B) outputs. Launches on `stream` and returns
// cudaGetLastError().
extern "C" int ec_comb_p256(const int32_t* scalars, const int32_t* tables,
                            const int32_t* negbase, int32_t* ax, int32_t* ay, int32_t* z,
                            int64_t B, void* stream) {
  return launch(comb_p256_kernel, scalars, tables, negbase, ax, ay, z, B, stream);
}

extern "C" int ec_comb_p256_strict(const int32_t* scalars, const int32_t* tables,
                                   const int32_t* negbase, int32_t* ax, int32_t* ay, int32_t* z,
                                   int64_t B, void* stream) {
  return launch(comb_strict_p256_kernel, scalars, tables, negbase, ax, ay, z, B, stream);
}

extern "C" int ec_comb_secp256k1(const int32_t* scalars, const int32_t* tables,
                                 const int32_t* negbase, int32_t* ax, int32_t* ay, int32_t* z,
                                 int64_t B, void* stream) {
  return launch(comb_secp256k1_kernel, scalars, tables, negbase, ax, ay, z, B, stream);
}

extern "C" int ec_comb_secp256k1_strict(const int32_t* scalars, const int32_t* tables,
                                        const int32_t* negbase, int32_t* ax, int32_t* ay,
                                        int32_t* z, int64_t B, void* stream) {
  return launch(comb_strict_secp256k1_kernel, scalars, tables, negbase, ax, ay, z, B, stream);
}

extern "C" int ec_comb_w25519(const int32_t* scalars, const int32_t* tables,
                              const int32_t* negbase, int32_t* ax, int32_t* ay, int32_t* z,
                              int64_t B, void* stream) {
  return launch(comb_w25519_kernel, scalars, tables, negbase, ax, ay, z, B, stream);
}

extern "C" int ec_comb_w25519_strict(const int32_t* scalars, const int32_t* tables,
                                     const int32_t* negbase, int32_t* ax, int32_t* ay,
                                     int32_t* z, int64_t B, void* stream) {
  return launch(comb_strict_w25519_kernel, scalars, tables, negbase, ax, ay, z, B, stream);
}
