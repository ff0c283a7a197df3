// secp256k1 field arithmetic (Montgomery, R = 2^256) for one lane per
// thread (NVIDIA Hopper, sm_90a).
//
// Replaces the Montgomery branch of ecsimd_tpu/kernels/digits.py and
// ecsimd_tpu/ops/mont.py (mont_mul / mont_sqr: the 16-digit product grid
// fed to a digit-serial CIOS reduction with m' = -p^-1 mod 2^16). Same
// Montgomery radix R = 2^256, so a residue x is stored as x R mod p on both
// sides and the Montgomery-form planes agree bit for bit: every function
// here returns the canonical value in [0, p).
//
// Limbs: 8 x 32-bit (limbs.cuh). A multiply is mul256.cuh's product (64
// products; a squaring 36), then fe_redc: the Montgomery reduction by
// words with m' = -p^-1 mod 2^32, written for the sparse p = 2^256 - 2^32 -
// 977 — two products a round (m and 977 m) where a dense p takes nine, so
// a multiply is 64 + 16 products and a squaring 36 + 16, against CIOS's
// 64 + 72 for both. Carries and borrows are PTX chains (no 64-bit
// arithmetic), as in limbs.cuh's add, sub and opposite.
//
// What bounds it on the card: the integer ALU and the multiply-add pipe
// nearly evenly: in kernel F, 55 % of the instructions are ALU (the column
// accumulator's top word, the reduction's borrow chains, the formulas' adds
// and subs) and 44 % multiply-add (bench/sass.py, CUDA 12.8).

#pragma once

#include "limbs.cuh"
#include "mul256.cuh"

namespace secp256k1 {

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

// p = 2^256 - 2^32 - 977
#define SECP256K1_P \
  {0xFFFFFC2Fu, 0xFFFFFFFEu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu}
// -p^-1 mod 2^32
constexpr uint32_t kMPrime = 0xD2253531u;

__device__ __forceinline__ fe fe_add(const fe& a, const fe& b) {
  const uint32_t P[8] = SECP256K1_P;
  return ec::fe_add_mod(a, b, P);
}

__device__ __forceinline__ fe fe_sub(const fe& a, const fe& b) {
  const uint32_t P[8] = SECP256K1_P;
  return ec::fe_sub_mod(a, b, P);
}

__device__ __forceinline__ fe fe_dbl(const fe& a) { return fe_add(a, a); }

__device__ __forceinline__ fe fe_neg(const fe& a) {
  const uint32_t P[8] = SECP256K1_P;
  return ec::fe_neg_mod(a, P);
}

// t * 2^-256 mod p for t < p 2^256 (t[0..15], consumed): the Montgomery
// reduction with R = 2^256, word by word, using that p = 2^256 - (2^32 +
// 977). Round i takes m = t_i m' mod 2^32 and adds m p = m 2^256 - m 2^32 -
// 977 m: the low word of 977 m is t_i (977 m' = 1 mod 2^32), so word i
// cancels with no borrow, and e = hi(977 m) + m (a word and a carry bit)
// is subtracted from words i + 1 and i + 2; the borrow out of word i + 2
// waits one round, for word i + 3. Each round is two products (t_i m' and
// 977 m), where CIOS takes nine. After the 8 rounds the words 8 .. 15,
// plus M = (m_0 .. m_7), minus the last pending borrow at word 10, are
// (t + M p) / 2^256 < 2p; one conditional subtract (its carry word
// included) makes it canonical. tests/test_torch_field_words.py:k1_redc
// transcribes it and asserts the bound.
__device__ __forceinline__ fe fe_redc(uint32_t t[16]) {
  fe m;
  uint32_t pend = 0u;  // the borrow owed to word i + 2 of round i
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m.v[i] = t[i] * kMPrime;
    asm("{\n\t"
        ".reg .u32 e1, e2;\n\t"
        "mul.hi.u32 e1, %3, 977;\n\t"
        "add.cc.u32 e1, e1, %3;\n\t"
        "addc.u32 e2, %2, 0;\n\t"
        "sub.cc.u32 %0, %0, e1;\n\t"
        "subc.cc.u32 %1, %1, e2;\n\t"
        "subc.u32 %2, 0, 0;\n\t"
        "}"
        : "+r"(t[i + 1]), "+r"(t[i + 2]), "+r"(pend)
        : "r"(m.v[i]));
    pend &= 1u;
  }
  fe hi, r;
#pragma unroll
  for (int j = 0; j < 8; ++j) hi.v[j] = t[8 + j];
  uint32_t top = ec::add8(r, hi, m);
  asm("sub.cc.u32 %0, %0, %7;\n\t"
      "subc.cc.u32 %1, %1, 0;\n\t"
      "subc.cc.u32 %2, %2, 0;\n\t"
      "subc.cc.u32 %3, %3, 0;\n\t"
      "subc.cc.u32 %4, %4, 0;\n\t"
      "subc.cc.u32 %5, %5, 0;\n\t"
      "subc.u32 %6, %6, 0;"
      : "+r"(r.v[2]), "+r"(r.v[3]), "+r"(r.v[4]), "+r"(r.v[5]), "+r"(r.v[6]), "+r"(r.v[7]),
        "+r"(top)
      : "r"(pend));
  const uint32_t P[8] = SECP256K1_P;
  return ec::fe_cond_sub(r, top, P);  // t < 2p
}

// a * b * R^-1 mod p for a, b in [0, p): mul256.cuh's product, fe_redc.
__device__ __forceinline__ fe fe_mul(const fe& a, const fe& b) {
  uint32_t t[16];
  ec::mul_wide(a, b, t);
  return fe_redc(t);
}

// a^2 R^-1 mod p: the dedicated squaring (36 products), fe_redc.
__device__ __forceinline__ fe fe_sqr(const fe& a) {
  uint32_t t[16];
  ec::sqr_wide(a, t);
  return fe_redc(t);
}

// k * a * b for k = 2, 4, as doublings (the JAX package's Montgomery
// fields scale the same way, by a double/add chain).
__device__ __forceinline__ fe fe_mul4(const fe& a, const fe& b) {
  return fe_dbl(fe_dbl(fe_mul(a, b)));
}

__device__ __forceinline__ fe fe_mul2(const fe& a, const fe& b) { return fe_dbl(fe_mul(a, b)); }

// The field's 1 in Montgomery form, R mod p = 2^32 + 977.
__device__ __forceinline__ fe fe_one() {
  fe r = fe_from_u32(0x000003D1u);
  r.v[1] = 1u;
  return r;
}

// Montgomery form -> classical residue: x R * 1 * R^-1, the reduction of
// (a, 0) with no product.
__device__ __forceinline__ fe fe_to_classical(const fe& a) {
  uint32_t t[16];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    t[j] = a.v[j];
    t[8 + j] = 0u;
  }
  return fe_redc(t);
}

// Fermat inversion a^(p-2) in Montgomery form, inverse(0) = 0: left-to-right
// square-and-multiply over the 256 bits of the public exponent from acc = 1
// (256 squarings and 249 multiplies: p - 2 has 249 set bits). The exponent
// is a constant, so every lane takes the same branches.
__device__ __forceinline__ fe fe_inv(const fe& a) {
  const uint32_t E[8] = {0xFFFFFC2Du, 0xFFFFFFFEu, 0xFFFFFFFFu, 0xFFFFFFFFu,
                         0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu};
  fe acc = fe_one();
#pragma unroll
  for (int w = 7; w >= 0; --w) {
    const uint32_t e = E[w];
#pragma unroll 1
    for (int bit = 31; bit >= 0; --bit) {
      acc = fe_sqr(acc);
      if ((e >> bit) & 1u) acc = fe_mul(acc, a);
    }
  }
  return acc;
}

}  // namespace secp256k1
