// P-384 field arithmetic for one lane per thread (NVIDIA Hopper, sm_90a).
//
// Replaces ecsimd_tpu/kernels/digits.py (field_mul / field_sqr with the
// Solinas reduction, mod_add / mod_sub / mod_opposite) and
// ecsimd_tpu/ops/solinas.py on P384_FIELD: p = 2^384 - 2^128 - 2^96 + 2^32
// - 1, 24 base-2^16 digits. Residues are stored plain (the classical form),
// as on P-256, and every function returns the canonical value in [0, p), so
// any correct reduction gives the JAX package's planes bit for bit, and a
// kernel that follows its formula sequence reproduces its Jacobian planes.
//
// Limbs: 12 x 32-bit (limbs.cuh's fe_t<12>). The product is mul_wide.cuh's
// Comba grid (144 products; the squaring 78). The reduction is the Solinas
// sum of FIPS 186-4 D.2.4 on 32-bit carry chains, all in one asm statement
// (fe_reduce): r = s1 + 2 s2 + s3 + s4 + s5 + s6 + s7 - d1 - d2 - d3, plus
// 2p so that no partial sum goes negative (2p > 2^384 + 2^161 covers the
// three subtracted terms; the adds come first), in a 13-word accumulator
// whose top word t ends in [0, 10]. Then t 2^384 folds as t (2^128 + 2^96 -
// 2^32 + 1): one add chain (t at words 0, 3 and 4), one sub chain (t at
// word 1). The folded value is below 2^384 + 2^132 < 2p, so one
// conditional subtract (its carry word included) makes it canonical.
// tests/test_torch_field_words.py runs the asm text on Python ints.
//
// fe_mul and fe_sqr are not inlined: each formula calls them, so a kernel
// holds one copy of the 144-product grid instead of one a field operation
// (inlined, the window and comb sources would take minutes of ptxas each).
// A source that defines EC_INLINE_FIELD_MULS before including this
// header inlines them (kernel A on P-384, ladder_p384.cu, whose lane holds
// no table).
//
// What bounds it on the card: the multiply-add pipe (one IMAD-class
// instruction a product) and the integer ALU pipe (the products' addc, the
// eleven reduction chains, the modular adds).

#pragma once

#include "limbs.cuh"
#include "mul_wide.cuh"

namespace p384 {

constexpr int kWords = 12;   // 32-bit limbs
constexpr int kDigits = 24;  // base-2^16 digit planes
#include "limbs_ns.cuh"

// p = 2^384 - 2^128 - 2^96 + 2^32 - 1
#define P384_P                                                                       \
  {0xFFFFFFFFu, 0x00000000u, 0x00000000u, 0xFFFFFFFFu, 0xFFFFFFFEu, 0xFFFFFFFFu, \
   0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu}

__device__ __forceinline__ fe fe_cond_sub_p(const fe& a, uint32_t carry) {
  const uint32_t P[kWords] = P384_P;
  return ec::fe_cond_sub(a, carry, P);
}

__device__ __forceinline__ fe fe_add(const fe& a, const fe& b) {
  const uint32_t P[kWords] = P384_P;
  return ec::fe_add_mod(a, b, P);
}

__device__ __forceinline__ fe fe_sub(const fe& a, const fe& b) {
  const uint32_t P[kWords] = P384_P;
  return ec::fe_sub_mod(a, b, P);
}

__device__ __forceinline__ fe fe_dbl(const fe& a) { return fe_add(a, a); }

__device__ __forceinline__ fe fe_neg(const fe& a) {
  const uint32_t P[kWords] = P384_P;
  return ec::fe_neg_mod(a, P);
}

// The field's 1, and a result as a classical residue: both trivial, the
// residues are stored plain.
__device__ __forceinline__ fe fe_one() { return fe_from_u32(1u); }

__device__ __forceinline__ fe fe_to_classical(const fe& a) { return a; }

// The Solinas reduction of a 768-bit product c[0..23] (see the header).
__device__ __forceinline__ fe fe_reduce(const uint32_t c[24]) {
  uint64_t cp[12], rp[6];
#pragma unroll
  for (int j = 0; j < 12; ++j) cp[j] = ec::pair(c, j);
  uint32_t hi;
  asm("{\n\t"
      ".reg .u32 c<24>, t<13>, r<12>;\n\t"
      "mov.b64 {c0, c1}, %7;\n\t"
      "mov.b64 {c2, c3}, %8;\n\t"
      "mov.b64 {c4, c5}, %9;\n\t"
      "mov.b64 {c6, c7}, %10;\n\t"
      "mov.b64 {c8, c9}, %11;\n\t"
      "mov.b64 {c10, c11}, %12;\n\t"
      "mov.b64 {c12, c13}, %13;\n\t"
      "mov.b64 {c14, c15}, %14;\n\t"
      "mov.b64 {c16, c17}, %15;\n\t"
      "mov.b64 {c18, c19}, %16;\n\t"
      "mov.b64 {c20, c21}, %17;\n\t"
      "mov.b64 {c22, c23}, %18;\n\t"
      "add.cc.u32 t0, c0, 0xFFFFFFFE;\n\t"
      "addc.cc.u32 t1, c1, 0x00000001;\n\t"
      "addc.cc.u32 t2, c2, 0x00000000;\n\t"
      "addc.cc.u32 t3, c3, 0xFFFFFFFE;\n\t"
      "addc.cc.u32 t4, c4, 0xFFFFFFFD;\n\t"
      "addc.cc.u32 t5, c5, 0xFFFFFFFF;\n\t"
      "addc.cc.u32 t6, c6, 0xFFFFFFFF;\n\t"
      "addc.cc.u32 t7, c7, 0xFFFFFFFF;\n\t"
      "addc.cc.u32 t8, c8, 0xFFFFFFFF;\n\t"
      "addc.cc.u32 t9, c9, 0xFFFFFFFF;\n\t"
      "addc.cc.u32 t10, c10, 0xFFFFFFFF;\n\t"
      "addc.cc.u32 t11, c11, 0xFFFFFFFF;\n\t"
      "addc.u32 t12, 0, 1;\n\t"
      "add.cc.u32 t4, t4, c21;\n\t"
      "addc.cc.u32 t5, t5, c22;\n\t"
      "addc.cc.u32 t6, t6, c23;\n\t"
      "addc.cc.u32 t7, t7, 0;\n\t"
      "addc.cc.u32 t8, t8, 0;\n\t"
      "addc.cc.u32 t9, t9, 0;\n\t"
      "addc.cc.u32 t10, t10, 0;\n\t"
      "addc.cc.u32 t11, t11, 0;\n\t"
      "addc.u32 t12, t12, 0;\n\t"
      "add.cc.u32 t4, t4, c21;\n\t"
      "addc.cc.u32 t5, t5, c22;\n\t"
      "addc.cc.u32 t6, t6, c23;\n\t"
      "addc.cc.u32 t7, t7, 0;\n\t"
      "addc.cc.u32 t8, t8, 0;\n\t"
      "addc.cc.u32 t9, t9, 0;\n\t"
      "addc.cc.u32 t10, t10, 0;\n\t"
      "addc.cc.u32 t11, t11, 0;\n\t"
      "addc.u32 t12, t12, 0;\n\t"
      "add.cc.u32 t0, t0, c12;\n\t"
      "addc.cc.u32 t1, t1, c13;\n\t"
      "addc.cc.u32 t2, t2, c14;\n\t"
      "addc.cc.u32 t3, t3, c15;\n\t"
      "addc.cc.u32 t4, t4, c16;\n\t"
      "addc.cc.u32 t5, t5, c17;\n\t"
      "addc.cc.u32 t6, t6, c18;\n\t"
      "addc.cc.u32 t7, t7, c19;\n\t"
      "addc.cc.u32 t8, t8, c20;\n\t"
      "addc.cc.u32 t9, t9, c21;\n\t"
      "addc.cc.u32 t10, t10, c22;\n\t"
      "addc.cc.u32 t11, t11, c23;\n\t"
      "addc.u32 t12, t12, 0;\n\t"
      "add.cc.u32 t0, t0, c21;\n\t"
      "addc.cc.u32 t1, t1, c22;\n\t"
      "addc.cc.u32 t2, t2, c23;\n\t"
      "addc.cc.u32 t3, t3, c12;\n\t"
      "addc.cc.u32 t4, t4, c13;\n\t"
      "addc.cc.u32 t5, t5, c14;\n\t"
      "addc.cc.u32 t6, t6, c15;\n\t"
      "addc.cc.u32 t7, t7, c16;\n\t"
      "addc.cc.u32 t8, t8, c17;\n\t"
      "addc.cc.u32 t9, t9, c18;\n\t"
      "addc.cc.u32 t10, t10, c19;\n\t"
      "addc.cc.u32 t11, t11, c20;\n\t"
      "addc.u32 t12, t12, 0;\n\t"
      "add.cc.u32 t1, t1, c23;\n\t"
      "addc.cc.u32 t2, t2, 0;\n\t"
      "addc.cc.u32 t3, t3, c20;\n\t"
      "addc.cc.u32 t4, t4, c12;\n\t"
      "addc.cc.u32 t5, t5, c13;\n\t"
      "addc.cc.u32 t6, t6, c14;\n\t"
      "addc.cc.u32 t7, t7, c15;\n\t"
      "addc.cc.u32 t8, t8, c16;\n\t"
      "addc.cc.u32 t9, t9, c17;\n\t"
      "addc.cc.u32 t10, t10, c18;\n\t"
      "addc.cc.u32 t11, t11, c19;\n\t"
      "addc.u32 t12, t12, 0;\n\t"
      "add.cc.u32 t4, t4, c20;\n\t"
      "addc.cc.u32 t5, t5, c21;\n\t"
      "addc.cc.u32 t6, t6, c22;\n\t"
      "addc.cc.u32 t7, t7, c23;\n\t"
      "addc.cc.u32 t8, t8, 0;\n\t"
      "addc.cc.u32 t9, t9, 0;\n\t"
      "addc.cc.u32 t10, t10, 0;\n\t"
      "addc.cc.u32 t11, t11, 0;\n\t"
      "addc.u32 t12, t12, 0;\n\t"
      "add.cc.u32 t0, t0, c20;\n\t"
      "addc.cc.u32 t1, t1, 0;\n\t"
      "addc.cc.u32 t2, t2, 0;\n\t"
      "addc.cc.u32 t3, t3, c21;\n\t"
      "addc.cc.u32 t4, t4, c22;\n\t"
      "addc.cc.u32 t5, t5, c23;\n\t"
      "addc.cc.u32 t6, t6, 0;\n\t"
      "addc.cc.u32 t7, t7, 0;\n\t"
      "addc.cc.u32 t8, t8, 0;\n\t"
      "addc.cc.u32 t9, t9, 0;\n\t"
      "addc.cc.u32 t10, t10, 0;\n\t"
      "addc.cc.u32 t11, t11, 0;\n\t"
      "addc.u32 t12, t12, 0;\n\t"
      "sub.cc.u32 t0, t0, c23;\n\t"
      "subc.cc.u32 t1, t1, c12;\n\t"
      "subc.cc.u32 t2, t2, c13;\n\t"
      "subc.cc.u32 t3, t3, c14;\n\t"
      "subc.cc.u32 t4, t4, c15;\n\t"
      "subc.cc.u32 t5, t5, c16;\n\t"
      "subc.cc.u32 t6, t6, c17;\n\t"
      "subc.cc.u32 t7, t7, c18;\n\t"
      "subc.cc.u32 t8, t8, c19;\n\t"
      "subc.cc.u32 t9, t9, c20;\n\t"
      "subc.cc.u32 t10, t10, c21;\n\t"
      "subc.cc.u32 t11, t11, c22;\n\t"
      "subc.u32 t12, t12, 0;\n\t"
      "sub.cc.u32 t1, t1, c20;\n\t"
      "subc.cc.u32 t2, t2, c21;\n\t"
      "subc.cc.u32 t3, t3, c22;\n\t"
      "subc.cc.u32 t4, t4, c23;\n\t"
      "subc.cc.u32 t5, t5, 0;\n\t"
      "subc.cc.u32 t6, t6, 0;\n\t"
      "subc.cc.u32 t7, t7, 0;\n\t"
      "subc.cc.u32 t8, t8, 0;\n\t"
      "subc.cc.u32 t9, t9, 0;\n\t"
      "subc.cc.u32 t10, t10, 0;\n\t"
      "subc.cc.u32 t11, t11, 0;\n\t"
      "subc.u32 t12, t12, 0;\n\t"
      "sub.cc.u32 t3, t3, c23;\n\t"
      "subc.cc.u32 t4, t4, c23;\n\t"
      "subc.cc.u32 t5, t5, 0;\n\t"
      "subc.cc.u32 t6, t6, 0;\n\t"
      "subc.cc.u32 t7, t7, 0;\n\t"
      "subc.cc.u32 t8, t8, 0;\n\t"
      "subc.cc.u32 t9, t9, 0;\n\t"
      "subc.cc.u32 t10, t10, 0;\n\t"
      "subc.cc.u32 t11, t11, 0;\n\t"
      "subc.u32 t12, t12, 0;\n\t"
      "add.cc.u32 r0, t0, t12;\n\t"
      "addc.cc.u32 r1, t1, 0;\n\t"
      "addc.cc.u32 r2, t2, 0;\n\t"
      "addc.cc.u32 r3, t3, t12;\n\t"
      "addc.cc.u32 r4, t4, t12;\n\t"
      "addc.cc.u32 r5, t5, 0;\n\t"
      "addc.cc.u32 r6, t6, 0;\n\t"
      "addc.cc.u32 r7, t7, 0;\n\t"
      "addc.cc.u32 r8, t8, 0;\n\t"
      "addc.cc.u32 r9, t9, 0;\n\t"
      "addc.cc.u32 r10, t10, 0;\n\t"
      "addc.cc.u32 r11, t11, 0;\n\t"
      "addc.u32 %6, 0, 0;\n\t"
      "sub.cc.u32 r1, r1, t12;\n\t"
      "subc.cc.u32 r2, r2, 0;\n\t"
      "subc.cc.u32 r3, r3, 0;\n\t"
      "subc.cc.u32 r4, r4, 0;\n\t"
      "subc.cc.u32 r5, r5, 0;\n\t"
      "subc.cc.u32 r6, r6, 0;\n\t"
      "subc.cc.u32 r7, r7, 0;\n\t"
      "subc.cc.u32 r8, r8, 0;\n\t"
      "subc.cc.u32 r9, r9, 0;\n\t"
      "subc.cc.u32 r10, r10, 0;\n\t"
      "subc.cc.u32 r11, r11, 0;\n\t"
      "subc.u32 %6, %6, 0;\n\t"
      "mov.b64 %0, {r0, r1};\n\t"
      "mov.b64 %1, {r2, r3};\n\t"
      "mov.b64 %2, {r4, r5};\n\t"
      "mov.b64 %3, {r6, r7};\n\t"
      "mov.b64 %4, {r8, r9};\n\t"
      "mov.b64 %5, {r10, r11};\n\t"
      "}"
      : "=l"(rp[0]), "=l"(rp[1]), "=l"(rp[2]), "=l"(rp[3]), "=l"(rp[4]), "=l"(rp[5]), "=r"(hi)
      : "l"(cp[0]), "l"(cp[1]), "l"(cp[2]), "l"(cp[3]), "l"(cp[4]), "l"(cp[5]), "l"(cp[6]),
        "l"(cp[7]), "l"(cp[8]), "l"(cp[9]), "l"(cp[10]), "l"(cp[11]));
  fe r;
#pragma unroll
  for (int j = 0; j < 6; ++j) ec::split(r.v, j, rp[j]);
  return fe_cond_sub_p(r, hi);
}

// Called, or inlined where a source defines EC_INLINE_FIELD_MULS first.
#ifdef EC_INLINE_FIELD_MULS
#define EC_FIELD_MULS __forceinline__
#else
#define EC_FIELD_MULS __noinline__
#endif

static __device__ EC_FIELD_MULS fe fe_mul(const fe a, const fe b) {
  uint32_t c[24];
  ec::mul_wide_n<kWords>(a, b, c);
  return fe_reduce(c);
}

static __device__ EC_FIELD_MULS fe fe_sqr(const fe a) {
  uint32_t c[24];
  ec::sqr_wide_n<kWords>(a, c);
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
// a^(2^k - 1) up to x_255, then p - 2's bits below them (a 0, 32 ones, 64
// zeros, 30 ones, then 01): 383 squarings on the chain (385 in all) and 14
// multiplies. The exponent is public, so every lane runs the same
// instructions.
__device__ __forceinline__ fe fe_inv(const fe& a) {
  const fe x2 = fe_mul(fe_sqr(a), a);
  const fe x3 = fe_mul(fe_sqr(x2), a);
  const fe x6 = fe_mul(fe_sqr_n(x3, 3), x3);
  const fe x12 = fe_mul(fe_sqr_n(x6, 6), x6);
  const fe x15 = fe_mul(fe_sqr_n(x12, 3), x3);
  const fe x30 = fe_mul(fe_sqr_n(x15, 15), x15);
  const fe x32 = fe_mul(fe_sqr_n(x30, 2), x2);
  const fe x60 = fe_mul(fe_sqr_n(x30, 30), x30);
  const fe x120 = fe_mul(fe_sqr_n(x60, 60), x60);
  const fe x240 = fe_mul(fe_sqr_n(x120, 120), x120);
  const fe x255 = fe_mul(fe_sqr_n(x240, 15), x15);
  fe t = fe_mul(fe_sqr_n(x255, 33), x32);  // bit 128 is 0, bits 127 .. 96 are 1
  t = fe_mul(fe_sqr_n(t, 94), x30);        // bits 95 .. 32 are 0, 31 .. 2 are 1
  return fe_mul(fe_sqr_n(t, 2), a);        // bits 1, 0: 01
}

}  // namespace p384
