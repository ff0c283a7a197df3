// secp256k1 field arithmetic (CIOS Montgomery) for one lane per thread
// (NVIDIA Hopper, sm_90a).
//
// Replaces the Montgomery branch of ecsimd_tpu/kernels/digits.py and
// ecsimd_tpu/ops/mont.py (mont_mul / mont_sqr: the 16-digit product grid
// fed to a digit-serial CIOS reduction with m' = -p^-1 mod 2^16). Same
// Montgomery radix R = 2^256, so a residue x is stored as x R mod p on both
// sides and the Montgomery-form planes agree bit for bit: every function
// here returns the canonical value in [0, p).
//
// Limbs: 8 x 32-bit (limbs.cuh). CIOS interleaves the product and the
// reduction one 32-bit word of a at a time: t += a_i * b (8 products), then
// m = t_0 * m' mod 2^32 with m' = -p^-1 mod 2^32, t = (t + m p) / 2^32
// (8 more products). After 8 rounds t < 2p, and one conditional subtract
// makes it canonical. The accumulators are 64-bit: each step adds a
// 32 x 32 -> 64 product to two 32-bit words, which cannot overflow.
//
// What bounds it on the card: 32-bit integer multiply-adds, 64 products
// for the grid and 8 x (1 + 8) for the reduction per multiply (a squaring
// is a full multiply here). The sparse p (2^256 - 2^32 - 977) would allow a
// cheaper reduction; that is later work.

#pragma once

#include "limbs.cuh"

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

// a * b * R^-1 mod p, CIOS, for a, b in [0, p).
__device__ __forceinline__ fe fe_mul(const fe& a, const fe& b) {
  const uint32_t P[8] = SECP256K1_P;
  uint32_t t[10];
#pragma unroll
  for (int j = 0; j < 10; ++j) t[j] = 0u;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      c += (uint64_t)a.v[i] * b.v[j] + t[j];
      t[j] = (uint32_t)c;
      c >>= 32;
    }
    c += t[8];
    t[8] = (uint32_t)c;
    t[9] = (uint32_t)(c >> 32);

    const uint32_t m = t[0] * kMPrime;
    c = ((uint64_t)m * P[0] + t[0]) >> 32;  // the low word is 0 by the choice of m
#pragma unroll
    for (int j = 1; j < 8; ++j) {
      c += (uint64_t)m * P[j] + t[j];
      t[j - 1] = (uint32_t)c;
      c >>= 32;
    }
    c += t[8];
    t[7] = (uint32_t)c;
    t[8] = t[9] + (uint32_t)(c >> 32);
  }
  fe r;
#pragma unroll
  for (int j = 0; j < 8; ++j) r.v[j] = t[j];
  return ec::fe_cond_sub(r, t[8], P);  // t < 2p
}

__device__ __forceinline__ fe fe_sqr(const fe& a) { return fe_mul(a, a); }

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

// Montgomery form -> classical residue: x R * 1 * R^-1.
__device__ __forceinline__ fe fe_to_classical(const fe& a) { return fe_mul(a, fe_from_u32(1u)); }

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
