// P-521 field arithmetic for one lane per thread (NVIDIA Hopper, sm_90a).
//
// Replaces the Crandall branch of ecsimd_tpu/kernels/digits.py and
// ecsimd_tpu/ops/crandall.py on P521_FIELD: p = 2^521 - 1 in 33 base-2^16
// digits (nbits = 528, cc = 2^528 mod p = 2^7). The kernel does not follow
// the Crandall planner: residues are stored plain and every function
// returns the canonical value in [0, p), so any correct reduction gives the
// JAX package's planes bit for bit, and a kernel that follows its formula
// sequence reproduces its Jacobian planes.
//
// Limbs: 17 x 32-bit (limbs.cuh's fe_t<17>), the top word holding bits 512
// .. 520 (9 bits) of a residue. The product is mul_wide.cuh's Comba grid
// (289 products; the squaring 153). The reduction is the Mersenne fold: a
// product t of two residues (t <= (p - 1)^2) is (t mod 2^521) + (t >> 521),
// the high part cut out of the words by funnel shifts (17 SHF), the sum one
// 17-word add chain; it is below 2^522 - 4 < 2p, so one conditional
// subtract makes it canonical. tests/test_torch_field_words.py transcribes
// the fold.
//
// fe_mul and fe_sqr are not inlined: each formula calls them, so a kernel
// holds one copy of the 289-product grid (inlined, ptxas would take many
// minutes on the window and comb sources).
//
// What bounds it on the card: the multiply-add pipe (one IMAD-class
// instruction a product) and the integer ALU pipe (the products' addc and
// the 17-word chains).

#pragma once

#include "limbs.cuh"
#include "mul_wide.cuh"

namespace p521 {

constexpr int kWords = 17;   // 32-bit limbs, the top one 9 bits of a residue
constexpr int kDigits = 33;  // base-2^16 digit planes
#include "limbs_ns.cuh"

// p = 2^521 - 1
#define P521_P                                                                   \
  {0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu, \
   0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu, \
   0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0x000001FFu}

__device__ __forceinline__ fe fe_add(const fe& a, const fe& b) {
  const uint32_t P[kWords] = P521_P;
  return ec::fe_add_mod(a, b, P);
}

__device__ __forceinline__ fe fe_sub(const fe& a, const fe& b) {
  const uint32_t P[kWords] = P521_P;
  return ec::fe_sub_mod(a, b, P);
}

__device__ __forceinline__ fe fe_dbl(const fe& a) { return fe_add(a, a); }

__device__ __forceinline__ fe fe_neg(const fe& a) {
  const uint32_t P[kWords] = P521_P;
  return ec::fe_neg_mod(a, P);
}

// The field's 1, and a result as a classical residue: both trivial, the
// residues are stored plain.
__device__ __forceinline__ fe fe_one() { return fe_from_u32(1u); }

__device__ __forceinline__ fe fe_to_classical(const fe& a) { return a; }

// A product c[0..33] of two residues mod p: lo = c mod 2^521 (words 0 ..
// 15 and 9 bits of word 16), hi = c >> 521 (word j: bits 9 .. 31 of
// c[16 + j] and bits 0 .. 8 of c[17 + j]), lo + hi < 2p, one conditional
// subtract.
__device__ __forceinline__ fe fe_reduce(const uint32_t c[34]) {
  const uint32_t P[kWords] = P521_P;
  fe lo, hi, s;
#pragma unroll
  for (int j = 0; j < 16; ++j) lo.v[j] = c[j];
  lo.v[16] = c[16] & 0x1FFu;
#pragma unroll
  for (int j = 0; j < kWords; ++j) hi.v[j] = __funnelshift_r(c[16 + j], c[17 + j], 9);
  const uint32_t carry = ec::add17(s, lo, hi);  // 0: lo + hi < 2^522
  return ec::fe_cond_sub(s, carry, P);
}

static __device__ __noinline__ fe fe_mul(const fe a, const fe b) {
  uint32_t c[34];
  ec::mul_wide_n<kWords>(a, b, c);
  return fe_reduce(c);
}

static __device__ __noinline__ fe fe_sqr(const fe a) {
  uint32_t c[34];
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

// Fermat inversion a^(p-2) = a^(2^521 - 3), inverse(0) = 0, by an addition
// chain: x_k = a^(2^k - 1) by doubling k up to x_512, then x_519 =
// x_512^(2^7) x_7 and the low bits 01: 520 squarings on the chain (524 in
// all) and 13 multiplies. The exponent is public, so every lane runs the
// same instructions.
__device__ __forceinline__ fe fe_inv(const fe& a) {
  const fe x2 = fe_mul(fe_sqr(a), a);
  const fe x3 = fe_mul(fe_sqr(x2), a);
  const fe x4 = fe_mul(fe_sqr_n(x2, 2), x2);
  const fe x7 = fe_mul(fe_sqr_n(x4, 3), x3);
  fe x = fe_mul(fe_sqr_n(x4, 4), x4);  // x_8
#pragma unroll 1
  for (int k = 8; k < 512; k *= 2) x = fe_mul(fe_sqr_n(x, k), x);  // x_16 .. x_512
  x = fe_mul(fe_sqr_n(x, 7), x7);     // x_519
  return fe_mul(fe_sqr_n(x, 2), a);   // 2^521 - 3
}

}  // namespace p521
