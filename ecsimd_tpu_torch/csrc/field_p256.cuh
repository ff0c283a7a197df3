// P-256 field arithmetic for one lane per thread (NVIDIA Hopper, sm_90a).
//
// Replaces ecsimd_tpu/kernels/digits.py, the digit-list field layer that the
// JAX package traces into every Pallas kernel (field_mul/field_sqr with the
// Solinas reduction, mod_add/mod_sub/mod_double/mod_opposite).
//
// Limb choice: 8 x 32-bit limbs, little-endian, in registers. The TPU used
// 16 x 16-bit digits because its vector unit has no 32x32->64 multiply;
// Hopper runs a 32x32->64 multiply-add (IMAD.WIDE) per instruction, so
// 32-bit limbs cut the schoolbook grid from 256 to 64 products and every
// carry ripple from 16 to 8 steps. Carries ride in 64-bit accumulators,
// which nvcc lowers to add-with-carry chains; no inline PTX is needed.
//
// The tensor interface stays the JAX package's (limbs.cuh, which also holds
// the loads, stores, selects and the modular add/sub shared with
// field_secp256k1.cuh).
//
// Every function returns a canonical value in [0, p). Because of that, any
// correct reduction gives the same result, and a kernel that follows the
// JAX package's formula sequence reproduces its Jacobian planes bit for bit.
//
// What bounds this code on the card: 32-bit integer multiply-add
// throughput (a field multiply is 64 wide multiply-adds plus a
// ~50-instruction reduction); memory traffic is a few words per lane per
// kernel.

#pragma once

#include "limbs.cuh"

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

// NIST fast reduction (FIPS 186-4 D.2.3) of a 512-bit product c[0..15]:
// r = s1 + 2 s2 + 2 s3 + s4 + s5 - s6 - s7 - s8 - s9, written per 32-bit
// word, rippled with a signed carry t in [-4, 6]; then t * 2^256 is folded
// back as t * (2^224 - 2^192 - 2^96 + 1) until no carry is left (two folds
// reach that for |t| < 2^31), and one conditional subtract of p, since the
// folded value is below 2^256 < 2p.
__device__ __forceinline__ fe fe_reduce(const uint32_t c[16]) {
  int64_t w[8];
  const int64_t c0 = c[0], c1 = c[1], c2 = c[2], c3 = c[3], c4 = c[4], c5 = c[5],
                c6 = c[6], c7 = c[7], c8 = c[8], c9 = c[9], c10 = c[10], c11 = c[11],
                c12 = c[12], c13 = c[13], c14 = c[14], c15 = c[15];
  w[0] = c0 + c8 + c9 - c11 - c12 - c13 - c14;
  w[1] = c1 + c9 + c10 - c12 - c13 - c14 - c15;
  w[2] = c2 + c10 + c11 - c13 - c14 - c15;
  w[3] = c3 + 2 * c11 + 2 * c12 + c13 - c15 - c8 - c9;
  w[4] = c4 + 2 * c12 + 2 * c13 + c14 - c9 - c10;
  w[5] = c5 + 2 * c13 + 2 * c14 + c15 - c10 - c11;
  w[6] = c6 + 3 * c14 + 2 * c15 + c13 - c8 - c9;
  w[7] = c7 + 3 * c15 + c8 - c10 - c11 - c12 - c13;

  fe r;
  int64_t t = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    t += w[j];
    r.v[j] = (uint32_t)t;
    t >>= 32;
  }
#pragma unroll
  for (int f = 0; f < 2; ++f) {
    // 2^256 = 2^224 - 2^192 - 2^96 + 1 (mod p): words 0:+1, 3:-1, 6:-1, 7:+1
    int64_t acc = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      int64_t k = (j == 0 || j == 7) ? t : ((j == 3 || j == 6) ? -t : 0);
      acc += (int64_t)r.v[j] + k;
      r.v[j] = (uint32_t)acc;
      acc >>= 32;
    }
    t = acc;
  }
  return fe_cond_sub_p(r, 0u);
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

__device__ __forceinline__ fe fe_sqr(const fe& a) { return fe_mul(a, a); }

// k * a * b for the small constants the formulas fuse (2, 4), as doublings:
// the residue is canonical, so it equals the JAX package's fused scaling.
__device__ __forceinline__ fe fe_mul4(const fe& a, const fe& b) {
  return fe_dbl(fe_dbl(fe_mul(a, b)));
}

__device__ __forceinline__ fe fe_mul2(const fe& a, const fe& b) { return fe_dbl(fe_mul(a, b)); }

// Fermat inversion a^(p-2), inverse(0) = 0: left-to-right square-and-multiply
// over the 256 bits of the public exponent from acc = 1 (256 squarings and
// 128 multiplies). The exponent is a constant, so every lane of a warp
// takes the same branches and the time does not depend on a. The bit loop
// stays rolled to keep the code small.
__device__ __forceinline__ fe fe_inv(const fe& a) {
  const uint32_t E[8] = {0xFFFFFFFDu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0u, 0u, 0u, 1u, 0xFFFFFFFFu};
  fe acc = fe_from_u32(1u);
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

}  // namespace p256
