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
// Constant time, memory accesses included: no address and no branch depends
// on the scalar. The TPU kernel reads every entry of a position through a
// one-hot product on its matrix unit; so does this one, on the tensor
// cores: the block stages each position's table in shared memory and each
// warp selects its 32 lanes' entries with u8 one-hot products
// (mma.sync.m16n8k32, comb_mma.cuh, which says how no address depends on
// the scalar).
//
// Tables (kernels/comb.mma_layout): u8, each position a K-major matrix of
// 64 rows (byte n of an entry: the 8 x-limbs then the 8 y-limbs of an
// affine point, 32-bit limbs in the field's internal form) and one column
// an entry. Position 0 keeps its 256 signed entries (the top digit folded
// in makes them not pairwise opposite); positions 1..31 keep only the 128
// positive entries (2m+1) 2^(8j) B and the sign is applied by a masked
// negation of y. So a position is 8 KiB (16 KiB for position 0), 264 KiB
// in all, read from L2 into shared memory by cp.async, double buffered:
// position j+1 is in flight while the lanes add position j.
//
// What bounds it: the chain's 32-bit multiply-adds (31 + 1 mixed adds of 7
// field multiplies and 4 squarings; strict: complete adds of 15 + 9 on
// P-256, 13 + 11 on secp256k1, 14 + 12 on Wei25519). The selection adds, a
// lane and a position, about 290 instructions (bench/sass.py): 64 IMMA (128
// at position 0), 16 ldmatrix, 32 16-bit stores and 8 8-byte loads of the
// row buffer, 4 shuffles and about 120 integer ALU instructions, where the
// masked scan it replaces issued about 3,000 (512 16-byte shared loads and
// 2,048 masked ORs).

#include "coz_p256.cuh"
#include "coz_secp256k1.cuh"
#include "coz_w25519.cuh"
#include "comb_mma.cuh"

namespace p256 {
#include "comb_lane.cuh"
#include "comb_mma_lane.cuh"
}  // namespace p256

namespace secp256k1 {
#include "comb_lane.cuh"
#include "comb_mma_lane.cuh"
}  // namespace secp256k1

namespace w25519 {
#include "comb_lane.cuh"
#include "comb_mma_lane.cuh"
}  // namespace w25519

namespace {
EC_COMB_MMA_KERNEL(comb_p256_kernel, p256, false)
EC_COMB_MMA_KERNEL(comb_strict_p256_kernel, p256, true)
EC_COMB_MMA_KERNEL(comb_secp256k1_kernel, secp256k1, false)
EC_COMB_MMA_KERNEL(comb_strict_secp256k1_kernel, secp256k1, true)
EC_COMB_MMA_KERNEL(comb_w25519_kernel, w25519, false)
EC_COMB_MMA_KERNEL(comb_strict_w25519_kernel, w25519, true)
}  // namespace

// scalars: (16, B) int32 digit planes; tables: 4224 x 64 bytes
// (kernels/comb.mma_layout), 16-byte aligned; negbase: 32 int32 digits (x
// then y) of -B, internal form; ax, ay, z: (16, B) outputs. Launches on
// `stream` and returns cudaGetLastError(); <entry>_smem returns the dynamic
// shared memory a block is given (smem_granted), <entry>_blocks the blocks
// an SM holds (blocks_granted).
extern "C" int ec_comb_p256(const int32_t* scalars, const uint8_t* tables,
                            const int32_t* negbase, int32_t* ax, int32_t* ay, int32_t* z,
                            int64_t B, void* stream) {
  return launch_serial<8>(comb_p256_kernel, scalars, tables, negbase, ax, ay, z, B, stream);
}

extern "C" int ec_comb_p256_strict(const int32_t* scalars, const uint8_t* tables,
                                   const int32_t* negbase, int32_t* ax, int32_t* ay, int32_t* z,
                                   int64_t B, void* stream) {
  return launch_serial<8>(comb_strict_p256_kernel, scalars, tables, negbase, ax, ay, z, B, stream);
}

extern "C" int ec_comb_secp256k1(const int32_t* scalars, const uint8_t* tables,
                                 const int32_t* negbase, int32_t* ax, int32_t* ay, int32_t* z,
                                 int64_t B, void* stream) {
  return launch_serial<8>(comb_secp256k1_kernel, scalars, tables, negbase, ax, ay, z, B, stream);
}

extern "C" int ec_comb_secp256k1_strict(const int32_t* scalars, const uint8_t* tables,
                                        const int32_t* negbase, int32_t* ax, int32_t* ay,
                                        int32_t* z, int64_t B, void* stream) {
  return launch_serial<8>(comb_strict_secp256k1_kernel, scalars, tables, negbase, ax, ay, z, B,
                          stream);
}

extern "C" int ec_comb_w25519(const int32_t* scalars, const uint8_t* tables,
                              const int32_t* negbase, int32_t* ax, int32_t* ay, int32_t* z,
                              int64_t B, void* stream) {
  return launch_serial<8>(comb_w25519_kernel, scalars, tables, negbase, ax, ay, z, B, stream);
}

extern "C" int ec_comb_w25519_strict(const int32_t* scalars, const uint8_t* tables,
                                     const int32_t* negbase, int32_t* ax, int32_t* ay,
                                     int32_t* z, int64_t B, void* stream) {
  return launch_serial<8>(comb_strict_w25519_kernel, scalars, tables, negbase, ax, ay, z, B,
                          stream);
}

extern "C" int ec_comb_p256_smem(void) { return smem_granted(comb_p256_kernel); }
extern "C" int ec_comb_p256_blocks(void) {
  return blocks_granted(comb_p256_kernel, comb::kThreads);
}
extern "C" int ec_comb_p256_strict_smem(void) { return smem_granted(comb_strict_p256_kernel); }
extern "C" int ec_comb_p256_strict_blocks(void) {
  return blocks_granted(comb_strict_p256_kernel, comb::kThreads);
}
extern "C" int ec_comb_secp256k1_smem(void) { return smem_granted(comb_secp256k1_kernel); }
extern "C" int ec_comb_secp256k1_blocks(void) {
  return blocks_granted(comb_secp256k1_kernel, comb::kThreads);
}
extern "C" int ec_comb_secp256k1_strict_smem(void) {
  return smem_granted(comb_strict_secp256k1_kernel);
}
extern "C" int ec_comb_secp256k1_strict_blocks(void) {
  return blocks_granted(comb_strict_secp256k1_kernel, comb::kThreads);
}
extern "C" int ec_comb_w25519_smem(void) { return smem_granted(comb_w25519_kernel); }
extern "C" int ec_comb_w25519_blocks(void) {
  return blocks_granted(comb_w25519_kernel, comb::kThreads);
}
extern "C" int ec_comb_w25519_strict_smem(void) { return smem_granted(comb_strict_w25519_kernel); }
extern "C" int ec_comb_w25519_strict_blocks(void) {
  return blocks_granted(comb_strict_w25519_kernel, comb::kThreads);
}
