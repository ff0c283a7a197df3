// P-256 field arithmetic for one lane per thread (NVIDIA Hopper, sm_90a).
//
// Replaces ecsimd_tpu/kernels/digits.py, the digit-list field layer that the
// JAX package traces into every Pallas kernel (field_mul/field_sqr with the
// Solinas reduction, mod_add/mod_sub/mod_double/mod_opposite).
//
// Limb choice: 8 x 32-bit limbs, little-endian, in registers. The TPU used
// 16 x 16-bit digits because its vector unit has no 32x32->64 multiply;
// Hopper runs 32-bit multiply-adds with carry chains, so 32-bit limbs cut
// the schoolbook grid from 256 to 64 products and every carry ripple from
// 16 to 8 steps.
//
// The multiply and the dedicated squaring (36 products) are mul256.cuh's,
// shared with field_secp256k1.cuh. The reduction is the Solinas sum of
// FIPS 186-4 D.2.3 on 32-bit add/sub carry chains in PTX (fe_reduce), and
// the modular add, sub and opposite are limbs.cuh's chains: no 64-bit
// arithmetic is left in the layer, since each 64-bit add costs the integer
// ALU two instructions and a 64-bit carry ripple a shift and an add a word.
//
// The tensor interface stays the JAX package's (limbs.cuh, which also holds
// the loads, stores and selects).
//
// Every function returns a canonical value in [0, p). Because of that, any
// correct reduction gives the same result, and a kernel that follows the
// JAX package's formula sequence reproduces its Jacobian planes bit for bit.
//
// What bounds this code on the card: the integer ALU pipe, then the
// multiply-add pipe. A multiply is 64 products (a squaring 36), about one
// IMAD-class instruction each; the ALU takes the column accumulator's top
// word, the reduction's eleven carry chains and the fold (about 120
// instructions), and the formulas' adds and subs (about 20 each): in
// kernel E, 73 % of the instructions are ALU (bench/sass.py, CUDA 12.8).
// Memory traffic is a few words per lane per kernel.

#pragma once

#include "limbs.cuh"
#include "mul256.cuh"

namespace p256 {

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

// p = 2^256 - 2^224 + 2^192 + 2^96 - 1
#define P256_P {0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0u, 0u, 0u, 1u, 0xFFFFFFFFu}

__device__ __forceinline__ fe fe_cond_sub_p(const fe& a, uint32_t carry) {
  const uint32_t P[8] = P256_P;
  return ec::fe_cond_sub(a, carry, P);
}

__device__ __forceinline__ fe fe_add(const fe& a, const fe& b) {
  const uint32_t P[8] = P256_P;
  return ec::fe_add_mod(a, b, P);
}

__device__ __forceinline__ fe fe_sub(const fe& a, const fe& b) {
  const uint32_t P[8] = P256_P;
  return ec::fe_sub_mod(a, b, P);
}

__device__ __forceinline__ fe fe_dbl(const fe& a) { return fe_add(a, a); }

__device__ __forceinline__ fe fe_neg(const fe& a) {
  const uint32_t P[8] = P256_P;
  return ec::fe_neg_mod(a, P);
}

// The field's 1, and the conversion of a result to a classical residue:
// P-256 residues are stored plain (no Montgomery factor), so both are trivial.
__device__ __forceinline__ fe fe_one() { return fe_from_u32(1u); }

__device__ __forceinline__ fe fe_to_classical(const fe& a) { return a; }

// t[0..8] += x, the carry into the top word t[8]. One add chain.
__device__ __forceinline__ void acc_add8(uint32_t t[9], uint32_t x0, uint32_t x1, uint32_t x2,
                                         uint32_t x3, uint32_t x4, uint32_t x5, uint32_t x6,
                                         uint32_t x7) {
  asm("add.cc.u32 %0, %0, %9;\n\t"
      "addc.cc.u32 %1, %1, %10;\n\t"
      "addc.cc.u32 %2, %2, %11;\n\t"
      "addc.cc.u32 %3, %3, %12;\n\t"
      "addc.cc.u32 %4, %4, %13;\n\t"
      "addc.cc.u32 %5, %5, %14;\n\t"
      "addc.cc.u32 %6, %6, %15;\n\t"
      "addc.cc.u32 %7, %7, %16;\n\t"
      "addc.u32 %8, %8, 0;"
      : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]), "+r"(t[5]), "+r"(t[6]),
        "+r"(t[7]), "+r"(t[8])
      : "r"(x0), "r"(x1), "r"(x2), "r"(x3), "r"(x4), "r"(x5), "r"(x6), "r"(x7));
}

// t[3..8] += (x3 .. x7) at words 3 .. 7, the carry into t[8].
__device__ __forceinline__ void acc_add_hi5(uint32_t t[9], uint32_t x3, uint32_t x4,
                                            uint32_t x5, uint32_t x6, uint32_t x7) {
  asm("add.cc.u32 %0, %0, %6;\n\t"
      "addc.cc.u32 %1, %1, %7;\n\t"
      "addc.cc.u32 %2, %2, %8;\n\t"
      "addc.cc.u32 %3, %3, %9;\n\t"
      "addc.cc.u32 %4, %4, %10;\n\t"
      "addc.u32 %5, %5, 0;"
      : "+r"(t[3]), "+r"(t[4]), "+r"(t[5]), "+r"(t[6]), "+r"(t[7]), "+r"(t[8])
      : "r"(x3), "r"(x4), "r"(x5), "r"(x6), "r"(x7));
}

// t[0..8] -= x, the borrow out of the top word t[8].
__device__ __forceinline__ void acc_sub8(uint32_t t[9], uint32_t x0, uint32_t x1, uint32_t x2,
                                         uint32_t x3, uint32_t x4, uint32_t x5, uint32_t x6,
                                         uint32_t x7) {
  asm("sub.cc.u32 %0, %0, %9;\n\t"
      "subc.cc.u32 %1, %1, %10;\n\t"
      "subc.cc.u32 %2, %2, %11;\n\t"
      "subc.cc.u32 %3, %3, %12;\n\t"
      "subc.cc.u32 %4, %4, %13;\n\t"
      "subc.cc.u32 %5, %5, %14;\n\t"
      "subc.cc.u32 %6, %6, %15;\n\t"
      "subc.cc.u32 %7, %7, %16;\n\t"
      "subc.u32 %8, %8, 0;"
      : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]), "+r"(t[5]), "+r"(t[6]),
        "+r"(t[7]), "+r"(t[8])
      : "r"(x0), "r"(x1), "r"(x2), "r"(x3), "r"(x4), "r"(x5), "r"(x6), "r"(x7));
}

// NIST fast reduction (FIPS 186-4 D.2.3) of a 512-bit product c[0..15] on
// 32-bit carry chains: r = s1 + 2 s2 + 2 s3 + s4 + s5 - s6 - s7 - s8 - s9,
// plus 5p so that no partial sum goes negative (5p > 4 2^256 covers the
// four subtracted terms), in a nine-word accumulator whose top word t ends
// in [0, 11]. Then t 2^256 folds as t (2^224 - 2^192 - 2^96 + 1): one add
// chain (t at words 0 and 7), one sub chain (t at words 3 and 6). The
// folded value is below 2^256 + 11 2^224 < 2p, so one conditional subtract
// (its carry word included) makes it canonical. No 64-bit arithmetic.
__device__ __forceinline__ fe fe_reduce(const uint32_t c[16]) {
  // 5p = 4 2^256 + these words
  uint32_t t[9] = {0xFFFFFFFBu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0x00000004u, 0u, 0u,
                   0x00000005u, 0xFFFFFFFBu, 4u};
  acc_add8(t, c[0], c[1], c[2], c[3], c[4], c[5], c[6], c[7]);        // s1
  acc_add_hi5(t, c[11], c[12], c[13], c[14], c[15]);                  // s2
  acc_add_hi5(t, c[11], c[12], c[13], c[14], c[15]);                  // s2
  acc_add_hi5(t, c[12], c[13], c[14], c[15], 0u);                     // s3
  acc_add_hi5(t, c[12], c[13], c[14], c[15], 0u);                     // s3
  acc_add8(t, c[8], c[9], c[10], 0u, 0u, 0u, c[14], c[15]);           // s4
  acc_add8(t, c[9], c[10], c[11], c[13], c[14], c[15], c[13], c[8]);  // s5
  acc_sub8(t, c[11], c[12], c[13], 0u, 0u, 0u, c[8], c[10]);          // s6
  acc_sub8(t, c[12], c[13], c[14], c[15], 0u, 0u, c[9], c[11]);       // s7
  acc_sub8(t, c[13], c[14], c[15], c[8], c[9], c[10], 0u, c[12]);     // s8
  acc_sub8(t, c[14], c[15], 0u, c[9], c[10], c[11], 0u, c[13]);       // s9

  fe r;
  uint32_t hi;
  asm("add.cc.u32 %0, %9, %17;\n\t"
      "addc.cc.u32 %1, %10, 0;\n\t"
      "addc.cc.u32 %2, %11, 0;\n\t"
      "addc.cc.u32 %3, %12, 0;\n\t"
      "addc.cc.u32 %4, %13, 0;\n\t"
      "addc.cc.u32 %5, %14, 0;\n\t"
      "addc.cc.u32 %6, %15, 0;\n\t"
      "addc.cc.u32 %7, %16, %17;\n\t"
      "addc.u32 %8, 0, 0;\n\t"
      "sub.cc.u32 %3, %3, %17;\n\t"
      "subc.cc.u32 %4, %4, 0;\n\t"
      "subc.cc.u32 %5, %5, 0;\n\t"
      "subc.cc.u32 %6, %6, %17;\n\t"
      "subc.cc.u32 %7, %7, 0;\n\t"
      "subc.u32 %8, %8, 0;"
      : "=r"(r.v[0]), "=r"(r.v[1]), "=r"(r.v[2]), "=r"(r.v[3]), "=r"(r.v[4]), "=r"(r.v[5]),
        "=r"(r.v[6]), "=r"(r.v[7]), "=r"(hi)
      : "r"(t[0]), "r"(t[1]), "r"(t[2]), "r"(t[3]), "r"(t[4]), "r"(t[5]), "r"(t[6]),
        "r"(t[7]), "r"(t[8]));
  return fe_cond_sub_p(r, hi);
}

__device__ __forceinline__ fe fe_mul(const fe& a, const fe& b) {
  uint32_t c[16];
  ec::mul_wide(a, b, c);
  return fe_reduce(c);
}

__device__ __forceinline__ fe fe_sqr(const fe& a) {
  uint32_t c[16];
  ec::sqr_wide(a, c);
  return fe_reduce(c);
}

// k * a * b for the small constants the formulas fuse (2, 4), as doublings:
// the residue is canonical, so it equals the JAX package's fused scaling.
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

// Fermat inversion a^(p-2), inverse(0) = 0, by an addition chain: x_k =
// a^(2^k - 1) for k = 2, 3, 6, 12, 15, 30, 32, then p - 2's bits from the
// top (32 ones, 31 zeros, a one, 96 zeros, 94 ones, then 01): 255
// squarings and 12 multiplies. The exponent is public, so every lane runs
// the same instructions.
__device__ __forceinline__ fe fe_inv(const fe& a) {
  const fe x2 = fe_mul(fe_sqr(a), a);
  const fe x3 = fe_mul(fe_sqr(x2), a);
  const fe x6 = fe_mul(fe_sqr_n(x3, 3), x3);
  const fe x12 = fe_mul(fe_sqr_n(x6, 6), x6);
  const fe x15 = fe_mul(fe_sqr_n(x12, 3), x3);
  const fe x30 = fe_mul(fe_sqr_n(x15, 15), x15);
  const fe x32 = fe_mul(fe_sqr_n(x30, 2), x2);
  fe t = fe_mul(fe_sqr_n(x32, 32), a);  // bits 255 .. 192
  t = fe_mul(fe_sqr_n(t, 128), x32);    // 96 zeros, then bits 95 .. 64
  t = fe_mul(fe_sqr_n(t, 32), x32);     // bits 63 .. 32
  t = fe_mul(fe_sqr_n(t, 30), x30);     // bits 31 .. 2
  return fe_mul(fe_sqr_n(t, 2), a);     // bits 1, 0: 01
}

}  // namespace p256
