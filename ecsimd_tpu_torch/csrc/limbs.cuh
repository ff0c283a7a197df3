// Field-independent 256-bit limb helpers for one lane per thread (sm_90a).
//
// A field element is 8 x 32-bit limbs, little-endian, in registers
// (field_p256.cuh says why 32-bit limbs). The tensor interface is the JAX
// package's: (16, B) int32 planes of base-2^16 digits, digit k of lane i at
// planes[k * B + i], so neighbouring threads read neighbouring words.
// fe_load / fe_store convert at the edges. Every field header
// (field_p256.cuh, field_secp256k1.cuh, field_w25519.cuh) brings these
// names into its own namespace, beside its modular arithmetic.
//
// The modular add, sub, opposite and conditional subtract are PTX carry
// chains, one add.cc / sub.cc a word and a masked select (a 64-bit ripple
// costs the integer ALU an add, a shift and an extract a word). What
// bounds them: the integer ALU pipe, about 20 instructions an add or sub.

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

// The modular add, sub, opposite and conditional subtract below are PTX
// carry chains on the 32-bit words: add.cc / addc and sub.cc / subc, each
// chain inside one asm statement (the carry flag does not live from one asm
// statement to the next). The choice at the end of each is a mask, so no
// branch depends on the values. tests/test_torch_field_words.py
// transcribes them instruction for instruction.

// r = a + b mod 2^256; returns the carry out (0 or 1).
__device__ __forceinline__ uint32_t add8(fe& r, const fe& a, const fe& b) {
  uint32_t c;
  asm("add.cc.u32 %0, %9, %17;\n\t"
      "addc.cc.u32 %1, %10, %18;\n\t"
      "addc.cc.u32 %2, %11, %19;\n\t"
      "addc.cc.u32 %3, %12, %20;\n\t"
      "addc.cc.u32 %4, %13, %21;\n\t"
      "addc.cc.u32 %5, %14, %22;\n\t"
      "addc.cc.u32 %6, %15, %23;\n\t"
      "addc.cc.u32 %7, %16, %24;\n\t"
      "addc.u32 %8, 0, 0;"
      : "=r"(r.v[0]), "=r"(r.v[1]), "=r"(r.v[2]), "=r"(r.v[3]), "=r"(r.v[4]), "=r"(r.v[5]),
        "=r"(r.v[6]), "=r"(r.v[7]), "=r"(c)
      : "r"(a.v[0]), "r"(a.v[1]), "r"(a.v[2]), "r"(a.v[3]), "r"(a.v[4]), "r"(a.v[5]),
        "r"(a.v[6]), "r"(a.v[7]), "r"(b.v[0]), "r"(b.v[1]), "r"(b.v[2]), "r"(b.v[3]),
        "r"(b.v[4]), "r"(b.v[5]), "r"(b.v[6]), "r"(b.v[7]));
  return c;
}

// r = a - b mod 2^256; returns x - borrow for a carry word x of a (0 or
// 1): all ones where a + x 2^256 < b. With x = 0 that is the borrow mask.
__device__ __forceinline__ uint32_t sub8(fe& r, const fe& a, const fe& b, uint32_t x) {
  uint32_t m;
  asm("sub.cc.u32 %0, %9, %17;\n\t"
      "subc.cc.u32 %1, %10, %18;\n\t"
      "subc.cc.u32 %2, %11, %19;\n\t"
      "subc.cc.u32 %3, %12, %20;\n\t"
      "subc.cc.u32 %4, %13, %21;\n\t"
      "subc.cc.u32 %5, %14, %22;\n\t"
      "subc.cc.u32 %6, %15, %23;\n\t"
      "subc.cc.u32 %7, %16, %24;\n\t"
      "subc.u32 %8, %25, 0;"
      : "=r"(r.v[0]), "=r"(r.v[1]), "=r"(r.v[2]), "=r"(r.v[3]), "=r"(r.v[4]), "=r"(r.v[5]),
        "=r"(r.v[6]), "=r"(r.v[7]), "=r"(m)
      : "r"(a.v[0]), "r"(a.v[1]), "r"(a.v[2]), "r"(a.v[3]), "r"(a.v[4]), "r"(a.v[5]),
        "r"(a.v[6]), "r"(a.v[7]), "r"(b.v[0]), "r"(b.v[1]), "r"(b.v[2]), "r"(b.v[3]),
        "r"(b.v[4]), "r"(b.v[5]), "r"(b.v[6]), "r"(b.v[7]), "r"(x));
  return m;
}

__device__ __forceinline__ fe fe_words(const uint32_t P[8]) {
  fe r;
#pragma unroll
  for (int j = 0; j < 8; ++j) r.v[j] = P[j];
  return r;
}

// a - P if (carry or a >= P), else a: a is kept only where carry - borrow
// is -1 (no carry, a < P); its sign bit spread over the word is the mask.
// The result is canonical when a + carry * 2^256 < 2P.
__device__ __forceinline__ fe fe_cond_sub(const fe& a, uint32_t carry, const uint32_t P[8]) {
  fe t;
  const uint32_t keep_a = (uint32_t)((int32_t)sub8(t, a, fe_words(P), carry) >> 31);
  fe r;
#pragma unroll
  for (int j = 0; j < 8; ++j) r.v[j] = (a.v[j] & keep_a) | (t.v[j] & ~keep_a);
  return r;
}

// (a + b) mod P for a, b in [0, P).
__device__ __forceinline__ fe fe_add_mod(const fe& a, const fe& b, const uint32_t P[8]) {
  fe s;
  const uint32_t c = add8(s, a, b);
  return fe_cond_sub(s, c, P);
}

// (a - b) mod P for a, b in [0, P): a - b, then P added back where it
// borrowed (P & mask).
__device__ __forceinline__ fe fe_sub_mod(const fe& a, const fe& b, const uint32_t P[8]) {
  fe d, pm, r;
  const uint32_t m = sub8(d, a, b, 0u);
#pragma unroll
  for (int j = 0; j < 8; ++j) pm.v[j] = P[j] & m;
  add8(r, d, pm);
  return r;
}

// (-a) mod P for a in [0, P); -0 = 0: P - a, masked to 0 where a == 0.
__device__ __forceinline__ fe fe_neg_mod(const fe& a, const uint32_t P[8]) {
  fe d;
  sub8(d, fe_words(P), a, 0u);
  const uint32_t nz = fe_is_zero(a) - 1u;  // all ones where a != 0
#pragma unroll
  for (int j = 0; j < 8; ++j) d.v[j] &= nz;
  return d;
}

}  // namespace ec
