// 2^255 - 19 field arithmetic (Crandall fold) for one lane per thread
// (NVIDIA Hopper, sm_90a).
//
// Replaces the Crandall branch of ecsimd_tpu/kernels/digits.py and
// ecsimd_tpu/ops/crandall.py (the product grid, a fold of the high columns
// by cc = 2^256 mod p = 38, bit folds at 2^255, one conditional subtract).
// Residues are stored plain, as on the Solinas field.
//
// Limbs: 8 x 32-bit (limbs.cuh). A multiply is mul256.cuh's Comba product
// (64 products; the dedicated squaring 36), shared with P-256 and
// secp256k1, then fe_reduce_lazy: lo + 38 hi on 32-bit PTX carry chains,
// then the bits from 255 up folded in at 19 each, which leaves a value
// below 2^255 + 1463 < 2p.
//
// Two sets of functions. The canonical ones (fe_add, fe_sub, fe_neg,
// fe_mul, fe_sqr, fe_inv) return the value in [0, p), so a kernel that
// follows the JAX package's formula sequence reproduces its planes bit for
// bit: every Wei25519 kernel and kernel H use them. The lazy ones
// (fe_add_lazy, fe_sub_lazy, fe_mul_lazy, fe_sqr_lazy, fe_mul_small_lazy)
// take and return any 256-bit words, congruent mod p to the canonical
// results, with no conditional subtract: kernel G's x-only ladder, which
// makes its two outputs canonical once at the end (fe_canonical), so its
// words equal the JAX package's too.
//
// What bounds it on the card: 32-bit integer multiply-adds and the ALU's
// carry chains. A multiply is 64 products plus 16 for the fold by 38, a
// squaring 36 plus 16, the small multiply by a24 = 121665 16; the lazy add
// and subtract are two 8-word chains each, the canonical ones a chain and
// a conditional subtract.

#pragma once

#include "limbs.cuh"
#include "mul256.cuh"

namespace w25519 {

using ec::fe;
using ec::fe_from_digits;
using ec::fe_from_u32;
using ec::fe_is_zero;
using ec::fe_load;
using ec::fe_select;
using ec::fe_store;
using ec::fe_swap_if;
using ec::fe_zero;
using ec::scalar_word;

constexpr int kWords = 8;    // 32-bit limbs (limbs.cuh's 8-word names above)
constexpr int kDigits = 16;  // base-2^16 digit planes

// p = 2^255 - 19
#define W25519_P \
  {0xFFFFFFEDu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0x7FFFFFFFu}

__device__ __forceinline__ fe fe_add(const fe& a, const fe& b) {
  const uint32_t P[8] = W25519_P;
  return ec::fe_add_mod(a, b, P);
}

__device__ __forceinline__ fe fe_sub(const fe& a, const fe& b) {
  const uint32_t P[8] = W25519_P;
  return ec::fe_sub_mod(a, b, P);
}

__device__ __forceinline__ fe fe_dbl(const fe& a) { return fe_add(a, a); }

__device__ __forceinline__ fe fe_neg(const fe& a) {
  const uint32_t P[8] = W25519_P;
  return ec::fe_neg_mod(a, P);
}

__device__ __forceinline__ fe fe_one() { return fe_from_u32(1u); }

__device__ __forceinline__ fe fe_to_classical(const fe& a) { return a; }

// The product's reduction and the lazy arithmetic below are PTX carry
// chains, one asm statement each (limbs.cuh says why); the choices are
// masks, so no branch depends on a value. tests/test_torch_field_words.py
// transcribes each of them instruction for instruction and holds it to
// Python ints.

// t[0..7] + t8 2^256 (t8 < 2^26) -> r = (t mod 2^255) + 19 (t >> 255):
// r = t (mod p), r < 2^255 + 19 (2 t8 + 1) < 2^256. The bits from 255 up,
// (t8 << 1) | (t7 >> 31), are one funnel shift; one add chain folds them.
__device__ __forceinline__ fe fe_fold19(const uint32_t t[8], uint32_t t8) {
  const uint32_t top = __funnelshift_l(t[7], t8, 1);
  fe r;
  asm("mad.lo.cc.u32 %0, %8, 19, %9;\n\t"
      "addc.cc.u32 %1, %10, 0;\n\t"
      "addc.cc.u32 %2, %11, 0;\n\t"
      "addc.cc.u32 %3, %12, 0;\n\t"
      "addc.cc.u32 %4, %13, 0;\n\t"
      "addc.cc.u32 %5, %14, 0;\n\t"
      "addc.cc.u32 %6, %15, 0;\n\t"
      "addc.u32 %7, %16, 0;"
      : "=&r"(r.v[0]), "=&r"(r.v[1]), "=&r"(r.v[2]), "=&r"(r.v[3]), "=&r"(r.v[4]),
        "=&r"(r.v[5]), "=&r"(r.v[6]), "=&r"(r.v[7])
      : "r"(top), "r"(t[0]), "r"(t[1]), "r"(t[2]), "r"(t[3]), "r"(t[4]), "r"(t[5]), "r"(t[6]),
        "r"(t[7] & 0x7FFFFFFFu));
  return r;
}

// Any 512-bit c[0..15] -> r = c (mod p), r < 2^255 + 1463: t = lo + 38 hi
// (2^256 = 38 mod p) on two chains, the low words of the 8 products 38 c_j
// then their high words one word up, which leaves t < 39 2^256 (top word
// t8 <= 38); then fe_fold19. No 64-bit arithmetic.
__device__ __forceinline__ fe fe_reduce_lazy(const uint32_t c[16]) {
  uint32_t t[8], t8;
  asm("mad.lo.cc.u32 %0, %17, 38, %9;\n\t"
      "madc.lo.cc.u32 %1, %18, 38, %10;\n\t"
      "madc.lo.cc.u32 %2, %19, 38, %11;\n\t"
      "madc.lo.cc.u32 %3, %20, 38, %12;\n\t"
      "madc.lo.cc.u32 %4, %21, 38, %13;\n\t"
      "madc.lo.cc.u32 %5, %22, 38, %14;\n\t"
      "madc.lo.cc.u32 %6, %23, 38, %15;\n\t"
      "madc.lo.cc.u32 %7, %24, 38, %16;\n\t"
      "addc.u32 %8, 0, 0;\n\t"
      "mad.hi.cc.u32 %1, %17, 38, %1;\n\t"
      "madc.hi.cc.u32 %2, %18, 38, %2;\n\t"
      "madc.hi.cc.u32 %3, %19, 38, %3;\n\t"
      "madc.hi.cc.u32 %4, %20, 38, %4;\n\t"
      "madc.hi.cc.u32 %5, %21, 38, %5;\n\t"
      "madc.hi.cc.u32 %6, %22, 38, %6;\n\t"
      "madc.hi.cc.u32 %7, %23, 38, %7;\n\t"
      "madc.hi.u32 %8, %24, 38, %8;"
      : "=&r"(t[0]), "=&r"(t[1]), "=&r"(t[2]), "=&r"(t[3]), "=&r"(t[4]), "=&r"(t[5]),
        "=&r"(t[6]), "=&r"(t[7]), "=&r"(t8)
      : "r"(c[0]), "r"(c[1]), "r"(c[2]), "r"(c[3]), "r"(c[4]), "r"(c[5]), "r"(c[6]), "r"(c[7]),
        "r"(c[8]), "r"(c[9]), "r"(c[10]), "r"(c[11]), "r"(c[12]), "r"(c[13]), "r"(c[14]),
        "r"(c[15]));
  return fe_fold19(t, t8);
}

// a * b and a^2 for a, b < 2^256 (any 256-bit words): mul256.cuh's product
// and squaring, then fe_reduce_lazy: r < 2^255 + 1463, not canonical.
__device__ __forceinline__ fe fe_mul_lazy(const fe& a, const fe& b) {
  uint32_t c[16];
  ec::mul_wide(a, b, c);
  return fe_reduce_lazy(c);
}

__device__ __forceinline__ fe fe_sqr_lazy(const fe& a) {
  uint32_t c[16];
  ec::sqr_wide(a, c);
  return fe_reduce_lazy(c);
}

// The canonical product: the lazy one is below 2^255 + 1463 < 2p, so one
// conditional subtract.
__device__ __forceinline__ fe fe_mul(const fe& a, const fe& b) {
  const uint32_t P[8] = W25519_P;
  return ec::fe_cond_sub(fe_mul_lazy(a, b), 0u, P);
}

__device__ __forceinline__ fe fe_sqr(const fe& a) {
  const uint32_t P[8] = W25519_P;
  return ec::fe_cond_sub(fe_sqr_lazy(a), 0u, P);
}

// k * a for a < 2^256 and a small constant k < 2^26 (the ladder's a24):
// the 8 products' low words, then their high words one word up (top word
// below k), then fe_fold19: r < 2^255 + 2^32, not canonical.
__device__ __forceinline__ fe fe_mul_small_lazy(const fe& a, uint32_t k) {
  uint32_t t[8], t8;
  asm("mul.lo.u32 %0, %9, %17;\n\t"
      "mul.lo.u32 %1, %10, %17;\n\t"
      "mul.lo.u32 %2, %11, %17;\n\t"
      "mul.lo.u32 %3, %12, %17;\n\t"
      "mul.lo.u32 %4, %13, %17;\n\t"
      "mul.lo.u32 %5, %14, %17;\n\t"
      "mul.lo.u32 %6, %15, %17;\n\t"
      "mul.lo.u32 %7, %16, %17;\n\t"
      "mad.hi.cc.u32 %1, %9, %17, %1;\n\t"
      "madc.hi.cc.u32 %2, %10, %17, %2;\n\t"
      "madc.hi.cc.u32 %3, %11, %17, %3;\n\t"
      "madc.hi.cc.u32 %4, %12, %17, %4;\n\t"
      "madc.hi.cc.u32 %5, %13, %17, %5;\n\t"
      "madc.hi.cc.u32 %6, %14, %17, %6;\n\t"
      "madc.hi.cc.u32 %7, %15, %17, %7;\n\t"
      "madc.hi.u32 %8, %16, %17, 0;"
      : "=&r"(t[0]), "=&r"(t[1]), "=&r"(t[2]), "=&r"(t[3]), "=&r"(t[4]), "=&r"(t[5]),
        "=&r"(t[6]), "=&r"(t[7]), "=&r"(t8)
      : "r"(a.v[0]), "r"(a.v[1]), "r"(a.v[2]), "r"(a.v[3]), "r"(a.v[4]), "r"(a.v[5]),
        "r"(a.v[6]), "r"(a.v[7]), "r"(k));
  return fe_fold19(t, t8);
}

// a + b for a, b < 2^256, r < 2^256, r = a + b (mod p): the 8-word add;
// its carry out (2^256 = 38) folds back as 38, whose own carry out (then
// the low word is below 38) folds back as 38 once more. Each fold adds 38
// masked by its carry: no branch.
__device__ __forceinline__ fe fe_add_lazy(const fe& a, const fe& b) {
  fe r;
  asm("{\n\t"
      ".reg .u32 m;\n\t"
      "add.cc.u32 %0, %8, %16;\n\t"
      "addc.cc.u32 %1, %9, %17;\n\t"
      "addc.cc.u32 %2, %10, %18;\n\t"
      "addc.cc.u32 %3, %11, %19;\n\t"
      "addc.cc.u32 %4, %12, %20;\n\t"
      "addc.cc.u32 %5, %13, %21;\n\t"
      "addc.cc.u32 %6, %14, %22;\n\t"
      "addc.cc.u32 %7, %15, %23;\n\t"
      "addc.u32 m, 0, 0;\n\t"
      "sub.u32 m, 0, m;\n\t"
      "and.b32 m, m, 38;\n\t"
      "add.cc.u32 %0, %0, m;\n\t"
      "addc.cc.u32 %1, %1, 0;\n\t"
      "addc.cc.u32 %2, %2, 0;\n\t"
      "addc.cc.u32 %3, %3, 0;\n\t"
      "addc.cc.u32 %4, %4, 0;\n\t"
      "addc.cc.u32 %5, %5, 0;\n\t"
      "addc.cc.u32 %6, %6, 0;\n\t"
      "addc.cc.u32 %7, %7, 0;\n\t"
      "addc.u32 m, 0, 0;\n\t"
      "sub.u32 m, 0, m;\n\t"
      "and.b32 m, m, 38;\n\t"
      "add.u32 %0, %0, m;\n\t"
      "}"
      : "=&r"(r.v[0]), "=&r"(r.v[1]), "=&r"(r.v[2]), "=&r"(r.v[3]), "=&r"(r.v[4]),
        "=&r"(r.v[5]), "=&r"(r.v[6]), "=&r"(r.v[7])
      : "r"(a.v[0]), "r"(a.v[1]), "r"(a.v[2]), "r"(a.v[3]), "r"(a.v[4]), "r"(a.v[5]),
        "r"(a.v[6]), "r"(a.v[7]), "r"(b.v[0]), "r"(b.v[1]), "r"(b.v[2]), "r"(b.v[3]),
        "r"(b.v[4]), "r"(b.v[5]), "r"(b.v[6]), "r"(b.v[7]));
  return r;
}

// a - b for a, b < 2^256, r < 2^256, r = a - b (mod p): the 8-word
// subtract; its borrow (2^256 = 38) folds back as -38, whose own borrow
// (then the low word is at least 2^32 - 38) folds back as -38 once more,
// each masked by its borrow.
__device__ __forceinline__ fe fe_sub_lazy(const fe& a, const fe& b) {
  fe r;
  asm("{\n\t"
      ".reg .u32 m;\n\t"
      "sub.cc.u32 %0, %8, %16;\n\t"
      "subc.cc.u32 %1, %9, %17;\n\t"
      "subc.cc.u32 %2, %10, %18;\n\t"
      "subc.cc.u32 %3, %11, %19;\n\t"
      "subc.cc.u32 %4, %12, %20;\n\t"
      "subc.cc.u32 %5, %13, %21;\n\t"
      "subc.cc.u32 %6, %14, %22;\n\t"
      "subc.cc.u32 %7, %15, %23;\n\t"
      "subc.u32 m, 0, 0;\n\t"
      "and.b32 m, m, 38;\n\t"
      "sub.cc.u32 %0, %0, m;\n\t"
      "subc.cc.u32 %1, %1, 0;\n\t"
      "subc.cc.u32 %2, %2, 0;\n\t"
      "subc.cc.u32 %3, %3, 0;\n\t"
      "subc.cc.u32 %4, %4, 0;\n\t"
      "subc.cc.u32 %5, %5, 0;\n\t"
      "subc.cc.u32 %6, %6, 0;\n\t"
      "subc.cc.u32 %7, %7, 0;\n\t"
      "subc.u32 m, 0, 0;\n\t"
      "and.b32 m, m, 38;\n\t"
      "sub.u32 %0, %0, m;\n\t"
      "}"
      : "=&r"(r.v[0]), "=&r"(r.v[1]), "=&r"(r.v[2]), "=&r"(r.v[3]), "=&r"(r.v[4]),
        "=&r"(r.v[5]), "=&r"(r.v[6]), "=&r"(r.v[7])
      : "r"(a.v[0]), "r"(a.v[1]), "r"(a.v[2]), "r"(a.v[3]), "r"(a.v[4]), "r"(a.v[5]),
        "r"(a.v[6]), "r"(a.v[7]), "r"(b.v[0]), "r"(b.v[1]), "r"(b.v[2]), "r"(b.v[3]),
        "r"(b.v[4]), "r"(b.v[5]), "r"(b.v[6]), "r"(b.v[7]));
  return r;
}

// Any a < 2^256 -> its canonical residue: fe_fold19 with no top word
// leaves a value below 2^255 + 19 < 2p, then one conditional subtract.
__device__ __forceinline__ fe fe_canonical(const fe& a) {
  const uint32_t P[8] = W25519_P;
  return ec::fe_cond_sub(fe_fold19(a.v, 0u), 0u, P);
}

// k * a * b for k = 2, 4, as doublings (the residue is canonical, so it
// equals the JAX package's fused scaling).
__device__ __forceinline__ fe fe_mul4(const fe& a, const fe& b) {
  return fe_dbl(fe_dbl(fe_mul(a, b)));
}

__device__ __forceinline__ fe fe_mul2(const fe& a, const fe& b) { return fe_dbl(fe_mul(a, b)); }

// a^(2^n): n squarings, the loop kept rolled.
__device__ __forceinline__ fe fe_sqr_n(fe a, int n) {
#pragma unroll 1
  for (int i = 0; i < n; ++i) a = fe_sqr(a);
  return a;
}

// Fermat inversion a^(p-2) = a^(2^255 - 21), inverse(0) = 0, by the
// standard 2^255 - 19 addition chain: 254 squarings and 11 multiplies. The
// exponent is public, so every lane runs the same instructions.
__device__ __forceinline__ fe fe_inv(const fe& z) {
  const fe z2 = fe_sqr(z);                                 // 2
  const fe z9 = fe_mul(fe_sqr_n(z2, 2), z);                // 9
  const fe z11 = fe_mul(z9, z2);                           // 11
  const fe z_5_0 = fe_mul(fe_sqr(z11), z9);                // 2^5 - 1
  const fe z_10_0 = fe_mul(fe_sqr_n(z_5_0, 5), z_5_0);     // 2^10 - 1
  const fe z_20_0 = fe_mul(fe_sqr_n(z_10_0, 10), z_10_0);  // 2^20 - 1
  const fe z_40_0 = fe_mul(fe_sqr_n(z_20_0, 20), z_20_0);  // 2^40 - 1
  const fe z_50_0 = fe_mul(fe_sqr_n(z_40_0, 10), z_10_0);  // 2^50 - 1
  const fe z_100_0 = fe_mul(fe_sqr_n(z_50_0, 50), z_50_0);     // 2^100 - 1
  const fe z_200_0 = fe_mul(fe_sqr_n(z_100_0, 100), z_100_0);  // 2^200 - 1
  const fe z_250_0 = fe_mul(fe_sqr_n(z_200_0, 50), z_50_0);    // 2^250 - 1
  return fe_mul(fe_sqr_n(z_250_0, 5), z11);                    // 2^255 - 21
}

}  // namespace w25519
