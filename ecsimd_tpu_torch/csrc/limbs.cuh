// Field-independent 256-bit limb helpers for one lane per thread (sm_90a).
//
// A field element is 8 x 32-bit limbs, little-endian, in registers
// (field_p256.cuh says why 32-bit limbs). The tensor interface is the JAX
// package's: (16, B) int32 planes of base-2^16 digits, digit k of lane i at
// planes[k * B + i], so neighbouring threads read neighbouring words.
// fe_load / fe_store convert at the edges. Every field header
// (field_p256.cuh, field_secp256k1.cuh) brings these names into its own
// namespace, beside its modular arithmetic.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ec {

struct fe {
  uint32_t v[8];
};

__device__ __forceinline__ fe fe_zero() {
  fe r;
#pragma unroll
  for (int j = 0; j < 8; ++j) r.v[j] = 0u;
  return r;
}

__device__ __forceinline__ fe fe_from_u32(uint32_t x) {
  fe r = fe_zero();
  r.v[0] = x;
  return r;
}

// Lane i of a (16, B) int32 base-2^16 digit plane set.
__device__ __forceinline__ fe fe_load(const int32_t* planes, int64_t B, int64_t i) {
  fe r;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    uint32_t lo = (uint32_t)planes[(2 * j) * B + i];
    uint32_t hi = (uint32_t)planes[(2 * j + 1) * B + i];
    r.v[j] = (lo & 0xFFFFu) | (hi << 16);
  }
  return r;
}

// 32-bit word w (bits 32w .. 32w+31) of lane i of a (16, B) digit plane set.
__device__ __forceinline__ uint32_t scalar_word(const int32_t* planes, int64_t B, int64_t i,
                                                int w) {
  return ((uint32_t)planes[(2 * w) * B + i] & 0xFFFFu) |
         ((uint32_t)planes[(2 * w + 1) * B + i] << 16);
}

__device__ __forceinline__ void fe_store(int32_t* planes, int64_t B, int64_t i, const fe& a) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    planes[(2 * j) * B + i] = (int32_t)(a.v[j] & 0xFFFFu);
    planes[(2 * j + 1) * B + i] = (int32_t)(a.v[j] >> 16);
  }
}

// Two base-2^16 digit rows -> 8 x 32-bit limbs.
__device__ __forceinline__ fe fe_from_digits(const int32_t* d) {
  fe r;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    r.v[j] = ((uint32_t)d[2 * j] & 0xFFFFu) | ((uint32_t)d[2 * j + 1] << 16);
  }
  return r;
}

// Branch-free r = m ? a : b (m in {0, 1}).
__device__ __forceinline__ fe fe_select(uint32_t m, const fe& a, const fe& b) {
  const uint32_t mask = 0u - m;
  fe r;
#pragma unroll
  for (int j = 0; j < 8; ++j) r.v[j] = (a.v[j] & mask) | (b.v[j] & ~mask);
  return r;
}

// Branch-free swap of a and b when m == 1.
__device__ __forceinline__ void fe_swap_if(uint32_t m, fe& a, fe& b) {
  const uint32_t mask = 0u - m;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    uint32_t t = (a.v[j] ^ b.v[j]) & mask;
    a.v[j] ^= t;
    b.v[j] ^= t;
  }
}

__device__ __forceinline__ uint32_t fe_is_zero(const fe& a) {
  uint32_t o = 0u;
#pragma unroll
  for (int j = 0; j < 8; ++j) o |= a.v[j];
  return o == 0u ? 1u : 0u;
}

// a - P if (carry or a >= P), else a. Needs a + carry * 2^256 < 2P.
__device__ __forceinline__ fe fe_cond_sub(const fe& a, uint32_t carry, const uint32_t P[8]) {
  fe t;
  int64_t acc = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    acc += (int64_t)a.v[j] - (int64_t)P[j];
    t.v[j] = (uint32_t)acc;
    acc >>= 32;  // 0 or -1
  }
  const uint32_t no_borrow = (uint32_t)(acc + 1);  // 1 when a >= P
  return fe_select(carry | no_borrow, t, a);
}

// (a + b) mod P for a, b in [0, P).
__device__ __forceinline__ fe fe_add_mod(const fe& a, const fe& b, const uint32_t P[8]) {
  fe s;
  uint64_t acc = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    acc += (uint64_t)a.v[j] + b.v[j];
    s.v[j] = (uint32_t)acc;
    acc >>= 32;
  }
  return fe_cond_sub(s, (uint32_t)acc, P);
}

// (a - b) mod P for a, b in [0, P).
__device__ __forceinline__ fe fe_sub_mod(const fe& a, const fe& b, const uint32_t P[8]) {
  fe d;
  int64_t acc = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    acc += (int64_t)a.v[j] - (int64_t)b.v[j];
    d.v[j] = (uint32_t)acc;
    acc >>= 32;
  }
  // a < b: add P back (mod 2^256)
  const uint32_t mask = (uint32_t)acc;  // 0 or 0xFFFFFFFF
  fe r;
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    c += (uint64_t)d.v[j] + (P[j] & mask);
    r.v[j] = (uint32_t)c;
    c >>= 32;
  }
  return r;
}

// (-a) mod P for a in [0, P); -0 = 0.
__device__ __forceinline__ fe fe_neg_mod(const fe& a, const uint32_t P[8]) {
  fe d;
  int64_t acc = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    acc += (int64_t)P[j] - (int64_t)a.v[j];
    d.v[j] = (uint32_t)acc;
    acc >>= 32;
  }
  return fe_select(fe_is_zero(a), a, d);
}

}  // namespace ec
