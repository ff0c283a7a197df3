// 2^255 - 19 field arithmetic (Crandall fold) for one lane per thread
// (NVIDIA Hopper, sm_90a).
//
// Replaces the Crandall branch of ecsimd_tpu/kernels/digits.py and
// ecsimd_tpu/ops/crandall.py (the product grid, a fold of the high columns
// by cc = 2^256 mod p = 38, bit folds at 2^255, one conditional subtract).
// Residues are stored plain, as on the Solinas field, and every function
// returns the canonical value in [0, p), so a kernel that follows the JAX
// package's formula sequence reproduces its planes bit for bit.
//
// Limbs: 8 x 32-bit (limbs.cuh). A product c[0..15] folds as
// lo + 38 hi (2^256 = 38 mod p) with a 64-bit accumulator, which leaves a
// carry word t <= 38; t folds in once more as 38 t, with a carry-out
// c2 in {0, 1} (when it is 1 the low words are below 38 t); then the
// value's bits from 255 up, (r >> 255) + 2 c2, fold in at 19 each, which
// leaves r < 2^255 + 19 < 2p for one conditional subtract.
//
// What bounds it on the card: 32-bit integer multiply-adds. A multiply is
// 64 products plus 8 for the fold, a squaring 36 plus 8, the small
// multiply by a24 = 121665 8 plus 1; the fold is a few adds with carry.

#pragma once

#include "limbs.cuh"

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

// r + t 2^256 (t < 2^26) -> the canonical residue.
__device__ __forceinline__ fe fe_fold(fe r, uint32_t t) {
  const uint32_t P[8] = W25519_P;
  uint64_t acc = (uint64_t)r.v[0] + (uint64_t)t * 38u;
  r.v[0] = (uint32_t)acc;
  acc >>= 32;
#pragma unroll
  for (int j = 1; j < 8; ++j) {
    acc += r.v[j];
    r.v[j] = (uint32_t)acc;
    acc >>= 32;
  }
  // value = r + c2 2^256, c2 = acc in {0, 1}; fold its bits from 255 up
  const uint32_t top = (r.v[7] >> 31) + 2u * (uint32_t)acc;
  r.v[7] &= 0x7FFFFFFFu;
  acc = (uint64_t)r.v[0] + 19u * top;
  r.v[0] = (uint32_t)acc;
  acc >>= 32;
#pragma unroll
  for (int j = 1; j < 8; ++j) {
    acc += r.v[j];
    r.v[j] = (uint32_t)acc;
    acc >>= 32;
  }
  return ec::fe_cond_sub(r, 0u, P);  // r < 2^255 + 19 < 2p
}

// A 512-bit product c[0..15] mod p: lo + 38 hi, then fe_fold.
__device__ __forceinline__ fe fe_reduce(const uint32_t c[16]) {
  fe r;
  uint64_t acc = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    acc += (uint64_t)c[j] + (uint64_t)c[j + 8] * 38u;
    r.v[j] = (uint32_t)acc;
    acc >>= 32;
  }
  return fe_fold(r, (uint32_t)acc);
}

__device__ __forceinline__ fe fe_mul(const fe& a, const fe& b) {
  uint32_t c[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) c[j] = 0u;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t acc = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      acc += (uint64_t)a.v[i] * b.v[j] + c[i + j];
      c[i + j] = (uint32_t)acc;
      acc >>= 32;
    }
    c[i + 8] = (uint32_t)acc;
  }
  return fe_reduce(c);
}

// a^2: the 28 cross products once, doubled, plus the 8 squares.
__device__ __forceinline__ fe fe_sqr(const fe& a) {
  uint32_t c[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) c[j] = 0u;
#pragma unroll
  for (int i = 0; i < 7; ++i) {
    uint64_t acc = 0;
#pragma unroll
    for (int j = i + 1; j < 8; ++j) {
      acc += (uint64_t)a.v[i] * a.v[j] + c[i + j];
      c[i + j] = (uint32_t)acc;
      acc >>= 32;
    }
    c[i + 8] = (uint32_t)acc;
  }
#pragma unroll
  for (int j = 15; j > 0; --j) c[j] = (c[j] << 1) | (c[j - 1] >> 31);
  c[0] <<= 1;
  uint64_t acc = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint64_t sq = (uint64_t)a.v[i] * a.v[i];
    acc += (uint64_t)c[2 * i] + (uint32_t)sq;
    c[2 * i] = (uint32_t)acc;
    acc >>= 32;
    acc += (uint64_t)c[2 * i + 1] + (sq >> 32);
    c[2 * i + 1] = (uint32_t)acc;
    acc >>= 32;
  }
  return fe_reduce(c);
}

// k * a for a small constant k < 2^26 (the ladder's a24): 8 products and
// the fold.
__device__ __forceinline__ fe fe_mul_small(const fe& a, uint32_t k) {
  fe r;
  uint64_t acc = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    acc += (uint64_t)a.v[j] * k;
    r.v[j] = (uint32_t)acc;
    acc >>= 32;
  }
  return fe_fold(r, (uint32_t)acc);
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
