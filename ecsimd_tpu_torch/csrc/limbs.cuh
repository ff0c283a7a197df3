// Field-independent limb helpers for one lane per thread (sm_90a), at every
// width the port runs: N = 8 32-bit words (the 256-bit fields), 12 (P-384)
// and 17 (P-521, whose top word holds 9 bits).
//
// A field element is N x 32-bit limbs, little-endian, in registers
// (field_p256.cuh says why 32-bit limbs): ec::fe_t<N>, with ec::fe the
// 8-word element. The tensor interface is the JAX package's: (D, B) int32
// planes of base-2^16 digits, D = 16, 24 or 33, digit k of lane i at
// planes[k * B + i], so neighbouring threads read neighbouring words.
// load_n / store_n convert at the edges; with D odd (P-521: 33 digits) the
// top word holds one digit, so no load reads or store writes a plane D.
// Every field header brings its width's names into its own namespace
// (field_p256.cuh, field_secp256k1.cuh and field_w25519.cuh the 8-word
// ones below; field_p384.cuh and field_p521.cuh through limbs_ns.cuh),
// beside its modular arithmetic.
//
// The modular add, sub, opposite and conditional subtract are PTX carry
// chains, one add.cc / sub.cc a word and a masked select (a 64-bit ripple
// costs the integer ALU an add, a shift and an extract a word). Each chain
// is one asm statement, since the carry flag does not live from one asm
// statement to the next, of at most 30 operands: at 8 words the words go
// one a register; at 12 and 17 they go two to a 64-bit register (mov.b64
// unpacks them inside the statement). What bounds them: the integer ALU
// pipe, about 20 instructions an add or sub at 8 words.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ec {

template <int N>
struct fe_t {
  uint32_t v[N];
};

using fe = fe_t<8>;

// Words a coordinate takes in the tables' 16-byte-vector layouts
// (window_table.cuh, comb_scan.cuh): N rounded up to a multiple of 4.
template <int N>
__host__ __device__ constexpr int padded_words() {
  return (N + 3) / 4 * 4;
}

template <int N>
__device__ __forceinline__ fe_t<N> zero_n() {
  fe_t<N> r;
#pragma unroll
  for (int j = 0; j < N; ++j) r.v[j] = 0u;
  return r;
}

template <int N>
__device__ __forceinline__ fe_t<N> from_u32_n(uint32_t x) {
  fe_t<N> r = zero_n<N>();
  r.v[0] = x;
  return r;
}

// Lane i of a (D, B) int32 base-2^16 digit plane set; with D odd the top
// word's high digit is 0 and no plane D is read.
template <int N, int D>
__device__ __forceinline__ fe_t<N> load_n(const int32_t* planes, int64_t B, int64_t i) {
  static_assert(D == 2 * N || D == 2 * N - 1, "N words hold D digits");
  fe_t<N> r;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const uint32_t lo = (uint32_t)planes[(2 * j) * B + i];
    const uint32_t hi = 2 * j + 1 < D ? (uint32_t)planes[(2 * j + 1) * B + i] : 0u;
    r.v[j] = (lo & 0xFFFFu) | (hi << 16);
  }
  return r;
}

// 32-bit word w (bits 32w .. 32w+31) of lane i of a (D, B) digit plane set;
// with D odd, word (D - 1) / 2 is its one digit (no plane D is read).
template <int D>
__device__ __forceinline__ uint32_t scalar_word_n(const int32_t* planes, int64_t B, int64_t i,
                                                  int w) {
  const uint32_t lo = (uint32_t)planes[(2 * w) * B + i] & 0xFFFFu;
  if constexpr (D % 2 == 0) {
    return lo | ((uint32_t)planes[(2 * w + 1) * B + i] << 16);
  } else {
    return 2 * w + 1 < D ? lo | ((uint32_t)planes[(2 * w + 1) * B + i] << 16) : lo;
  }
}

template <int N, int D>
__device__ __forceinline__ void store_n(int32_t* planes, int64_t B, int64_t i,
                                        const fe_t<N>& a) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
    planes[(2 * j) * B + i] = (int32_t)(a.v[j] & 0xFFFFu);
    if (2 * j + 1 < D) planes[(2 * j + 1) * B + i] = (int32_t)(a.v[j] >> 16);
  }
}

// D base-2^16 digits -> N x 32-bit limbs.
template <int N, int D>
__device__ __forceinline__ fe_t<N> from_digits_n(const int32_t* d) {
  fe_t<N> r;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const uint32_t hi = 2 * j + 1 < D ? (uint32_t)d[2 * j + 1] : 0u;
    r.v[j] = ((uint32_t)d[2 * j] & 0xFFFFu) | (hi << 16);
  }
  return r;
}

// The 8-word names of the 256-bit fields.

__device__ __forceinline__ fe fe_zero() { return zero_n<8>(); }

__device__ __forceinline__ fe fe_from_u32(uint32_t x) { return from_u32_n<8>(x); }

// Lane i of a (16, B) int32 base-2^16 digit plane set.
__device__ __forceinline__ fe fe_load(const int32_t* planes, int64_t B, int64_t i) {
  return load_n<8, 16>(planes, B, i);
}

// 32-bit word w (bits 32w .. 32w+31) of lane i of a (16, B) digit plane set.
__device__ __forceinline__ uint32_t scalar_word(const int32_t* planes, int64_t B, int64_t i,
                                                int w) {
  return scalar_word_n<16>(planes, B, i, w);
}

__device__ __forceinline__ void fe_store(int32_t* planes, int64_t B, int64_t i, const fe& a) {
  store_n<8, 16>(planes, B, i, a);
}

// Two base-2^16 digit rows -> 8 x 32-bit limbs.
__device__ __forceinline__ fe fe_from_digits(const int32_t* d) { return from_digits_n<8, 16>(d); }

// Branch-free r = m ? a : b (m in {0, 1}).
template <int N>
__device__ __forceinline__ fe_t<N> fe_select(uint32_t m, const fe_t<N>& a, const fe_t<N>& b) {
  const uint32_t mask = 0u - m;
  fe_t<N> r;
#pragma unroll
  for (int j = 0; j < N; ++j) r.v[j] = (a.v[j] & mask) | (b.v[j] & ~mask);
  return r;
}

// Branch-free swap of a and b when m == 1.
template <int N>
__device__ __forceinline__ void fe_swap_if(uint32_t m, fe_t<N>& a, fe_t<N>& b) {
  const uint32_t mask = 0u - m;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    uint32_t t = (a.v[j] ^ b.v[j]) & mask;
    a.v[j] ^= t;
    b.v[j] ^= t;
  }
}

template <int N>
__device__ __forceinline__ uint32_t fe_is_zero(const fe_t<N>& a) {
  uint32_t o = 0u;
#pragma unroll
  for (int j = 0; j < N; ++j) o |= a.v[j];
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

// The 12- and 17-word chains: the words of each operand go two to a
// 64-bit register (pair / split), so a whole chain is one asm statement of
// at most 30 operands. tests/test_torch_field_words.py runs these asm
// statements' text, instruction by instruction, on Python ints.
__device__ __forceinline__ uint64_t pair(const uint32_t* w, int j) {
  return ((uint64_t)w[2 * j + 1] << 32) | w[2 * j];
}

__device__ __forceinline__ void split(uint32_t* w, int j, uint64_t x) {
  w[2 * j] = (uint32_t)x;
  w[2 * j + 1] = (uint32_t)(x >> 32);
}

// r = a + b mod 2^384; returns the carry out (0 or 1).
__device__ __forceinline__ uint32_t add12(fe_t<12>& r, const fe_t<12>& a, const fe_t<12>& b) {
  uint64_t pa[6], pb[6], rp[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    pa[j] = pair(a.v, j);
    pb[j] = pair(b.v, j);
  }
  uint32_t c;
  asm("{\n\t"
      ".reg .u32 a<12>, b<12>, r<12>;\n\t"
      "mov.b64 {a0, a1}, %7;\n\t"
      "mov.b64 {a2, a3}, %8;\n\t"
      "mov.b64 {a4, a5}, %9;\n\t"
      "mov.b64 {a6, a7}, %10;\n\t"
      "mov.b64 {a8, a9}, %11;\n\t"
      "mov.b64 {a10, a11}, %12;\n\t"
      "mov.b64 {b0, b1}, %13;\n\t"
      "mov.b64 {b2, b3}, %14;\n\t"
      "mov.b64 {b4, b5}, %15;\n\t"
      "mov.b64 {b6, b7}, %16;\n\t"
      "mov.b64 {b8, b9}, %17;\n\t"
      "mov.b64 {b10, b11}, %18;\n\t"
      "add.cc.u32 r0, a0, b0;\n\t"
      "addc.cc.u32 r1, a1, b1;\n\t"
      "addc.cc.u32 r2, a2, b2;\n\t"
      "addc.cc.u32 r3, a3, b3;\n\t"
      "addc.cc.u32 r4, a4, b4;\n\t"
      "addc.cc.u32 r5, a5, b5;\n\t"
      "addc.cc.u32 r6, a6, b6;\n\t"
      "addc.cc.u32 r7, a7, b7;\n\t"
      "addc.cc.u32 r8, a8, b8;\n\t"
      "addc.cc.u32 r9, a9, b9;\n\t"
      "addc.cc.u32 r10, a10, b10;\n\t"
      "addc.cc.u32 r11, a11, b11;\n\t"
      "addc.u32 %6, 0, 0;\n\t"
      "mov.b64 %0, {r0, r1};\n\t"
      "mov.b64 %1, {r2, r3};\n\t"
      "mov.b64 %2, {r4, r5};\n\t"
      "mov.b64 %3, {r6, r7};\n\t"
      "mov.b64 %4, {r8, r9};\n\t"
      "mov.b64 %5, {r10, r11};\n\t"
      "}"
      : "=l"(rp[0]), "=l"(rp[1]), "=l"(rp[2]), "=l"(rp[3]), "=l"(rp[4]), "=l"(rp[5]), "=r"(c)
      : "l"(pa[0]), "l"(pa[1]), "l"(pa[2]), "l"(pa[3]), "l"(pa[4]), "l"(pa[5]), "l"(pb[0]),
        "l"(pb[1]), "l"(pb[2]), "l"(pb[3]), "l"(pb[4]), "l"(pb[5]));
#pragma unroll
  for (int j = 0; j < 6; ++j) split(r.v, j, rp[j]);
  return c;
}

// r = a - b mod 2^384; returns x - borrow, as sub8.
__device__ __forceinline__ uint32_t sub12(fe_t<12>& r, const fe_t<12>& a, const fe_t<12>& b,
                                          uint32_t x) {
  uint64_t pa[6], pb[6], rp[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    pa[j] = pair(a.v, j);
    pb[j] = pair(b.v, j);
  }
  uint32_t m;
  asm("{\n\t"
      ".reg .u32 a<12>, b<12>, r<12>;\n\t"
      "mov.b64 {a0, a1}, %7;\n\t"
      "mov.b64 {a2, a3}, %8;\n\t"
      "mov.b64 {a4, a5}, %9;\n\t"
      "mov.b64 {a6, a7}, %10;\n\t"
      "mov.b64 {a8, a9}, %11;\n\t"
      "mov.b64 {a10, a11}, %12;\n\t"
      "mov.b64 {b0, b1}, %13;\n\t"
      "mov.b64 {b2, b3}, %14;\n\t"
      "mov.b64 {b4, b5}, %15;\n\t"
      "mov.b64 {b6, b7}, %16;\n\t"
      "mov.b64 {b8, b9}, %17;\n\t"
      "mov.b64 {b10, b11}, %18;\n\t"
      "sub.cc.u32 r0, a0, b0;\n\t"
      "subc.cc.u32 r1, a1, b1;\n\t"
      "subc.cc.u32 r2, a2, b2;\n\t"
      "subc.cc.u32 r3, a3, b3;\n\t"
      "subc.cc.u32 r4, a4, b4;\n\t"
      "subc.cc.u32 r5, a5, b5;\n\t"
      "subc.cc.u32 r6, a6, b6;\n\t"
      "subc.cc.u32 r7, a7, b7;\n\t"
      "subc.cc.u32 r8, a8, b8;\n\t"
      "subc.cc.u32 r9, a9, b9;\n\t"
      "subc.cc.u32 r10, a10, b10;\n\t"
      "subc.cc.u32 r11, a11, b11;\n\t"
      "subc.u32 %6, %19, 0;\n\t"
      "mov.b64 %0, {r0, r1};\n\t"
      "mov.b64 %1, {r2, r3};\n\t"
      "mov.b64 %2, {r4, r5};\n\t"
      "mov.b64 %3, {r6, r7};\n\t"
      "mov.b64 %4, {r8, r9};\n\t"
      "mov.b64 %5, {r10, r11};\n\t"
      "}"
      : "=l"(rp[0]), "=l"(rp[1]), "=l"(rp[2]), "=l"(rp[3]), "=l"(rp[4]), "=l"(rp[5]), "=r"(m)
      : "l"(pa[0]), "l"(pa[1]), "l"(pa[2]), "l"(pa[3]), "l"(pa[4]), "l"(pa[5]), "l"(pb[0]),
        "l"(pb[1]), "l"(pb[2]), "l"(pb[3]), "l"(pb[4]), "l"(pb[5]), "r"(x));
#pragma unroll
  for (int j = 0; j < 6; ++j) split(r.v, j, rp[j]);
  return m;
}

// r = a + b mod 2^544; returns the carry out (0 or 1). Word 16 goes alone.
__device__ __forceinline__ uint32_t add17(fe_t<17>& r, const fe_t<17>& a, const fe_t<17>& b) {
  uint64_t pa[8], pb[8], rp[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    pa[j] = pair(a.v, j);
    pb[j] = pair(b.v, j);
  }
  uint32_t c;
  asm("{\n\t"
      ".reg .u32 a<16>, b<16>, r<16>;\n\t"
      "mov.b64 {a0, a1}, %10;\n\t"
      "mov.b64 {a2, a3}, %11;\n\t"
      "mov.b64 {a4, a5}, %12;\n\t"
      "mov.b64 {a6, a7}, %13;\n\t"
      "mov.b64 {a8, a9}, %14;\n\t"
      "mov.b64 {a10, a11}, %15;\n\t"
      "mov.b64 {a12, a13}, %16;\n\t"
      "mov.b64 {a14, a15}, %17;\n\t"
      "mov.b64 {b0, b1}, %19;\n\t"
      "mov.b64 {b2, b3}, %20;\n\t"
      "mov.b64 {b4, b5}, %21;\n\t"
      "mov.b64 {b6, b7}, %22;\n\t"
      "mov.b64 {b8, b9}, %23;\n\t"
      "mov.b64 {b10, b11}, %24;\n\t"
      "mov.b64 {b12, b13}, %25;\n\t"
      "mov.b64 {b14, b15}, %26;\n\t"
      "add.cc.u32 r0, a0, b0;\n\t"
      "addc.cc.u32 r1, a1, b1;\n\t"
      "addc.cc.u32 r2, a2, b2;\n\t"
      "addc.cc.u32 r3, a3, b3;\n\t"
      "addc.cc.u32 r4, a4, b4;\n\t"
      "addc.cc.u32 r5, a5, b5;\n\t"
      "addc.cc.u32 r6, a6, b6;\n\t"
      "addc.cc.u32 r7, a7, b7;\n\t"
      "addc.cc.u32 r8, a8, b8;\n\t"
      "addc.cc.u32 r9, a9, b9;\n\t"
      "addc.cc.u32 r10, a10, b10;\n\t"
      "addc.cc.u32 r11, a11, b11;\n\t"
      "addc.cc.u32 r12, a12, b12;\n\t"
      "addc.cc.u32 r13, a13, b13;\n\t"
      "addc.cc.u32 r14, a14, b14;\n\t"
      "addc.cc.u32 r15, a15, b15;\n\t"
      "addc.cc.u32 %8, %18, %27;\n\t"
      "addc.u32 %9, 0, 0;\n\t"
      "mov.b64 %0, {r0, r1};\n\t"
      "mov.b64 %1, {r2, r3};\n\t"
      "mov.b64 %2, {r4, r5};\n\t"
      "mov.b64 %3, {r6, r7};\n\t"
      "mov.b64 %4, {r8, r9};\n\t"
      "mov.b64 %5, {r10, r11};\n\t"
      "mov.b64 %6, {r12, r13};\n\t"
      "mov.b64 %7, {r14, r15};\n\t"
      "}"
      : "=l"(rp[0]), "=l"(rp[1]), "=l"(rp[2]), "=l"(rp[3]), "=l"(rp[4]), "=l"(rp[5]),
        "=l"(rp[6]), "=l"(rp[7]), "=r"(r.v[16]), "=r"(c)
      : "l"(pa[0]), "l"(pa[1]), "l"(pa[2]), "l"(pa[3]), "l"(pa[4]), "l"(pa[5]), "l"(pa[6]),
        "l"(pa[7]), "r"(a.v[16]), "l"(pb[0]), "l"(pb[1]), "l"(pb[2]), "l"(pb[3]), "l"(pb[4]),
        "l"(pb[5]), "l"(pb[6]), "l"(pb[7]), "r"(b.v[16]));
#pragma unroll
  for (int j = 0; j < 8; ++j) split(r.v, j, rp[j]);
  return c;
}

// r = a - b mod 2^544; returns x - borrow, as sub8. Word 16 is written
// before x is read: an early-clobber output.
__device__ __forceinline__ uint32_t sub17(fe_t<17>& r, const fe_t<17>& a, const fe_t<17>& b,
                                          uint32_t x) {
  uint64_t pa[8], pb[8], rp[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    pa[j] = pair(a.v, j);
    pb[j] = pair(b.v, j);
  }
  uint32_t m;
  asm("{\n\t"
      ".reg .u32 a<16>, b<16>, r<16>;\n\t"
      "mov.b64 {a0, a1}, %10;\n\t"
      "mov.b64 {a2, a3}, %11;\n\t"
      "mov.b64 {a4, a5}, %12;\n\t"
      "mov.b64 {a6, a7}, %13;\n\t"
      "mov.b64 {a8, a9}, %14;\n\t"
      "mov.b64 {a10, a11}, %15;\n\t"
      "mov.b64 {a12, a13}, %16;\n\t"
      "mov.b64 {a14, a15}, %17;\n\t"
      "mov.b64 {b0, b1}, %19;\n\t"
      "mov.b64 {b2, b3}, %20;\n\t"
      "mov.b64 {b4, b5}, %21;\n\t"
      "mov.b64 {b6, b7}, %22;\n\t"
      "mov.b64 {b8, b9}, %23;\n\t"
      "mov.b64 {b10, b11}, %24;\n\t"
      "mov.b64 {b12, b13}, %25;\n\t"
      "mov.b64 {b14, b15}, %26;\n\t"
      "sub.cc.u32 r0, a0, b0;\n\t"
      "subc.cc.u32 r1, a1, b1;\n\t"
      "subc.cc.u32 r2, a2, b2;\n\t"
      "subc.cc.u32 r3, a3, b3;\n\t"
      "subc.cc.u32 r4, a4, b4;\n\t"
      "subc.cc.u32 r5, a5, b5;\n\t"
      "subc.cc.u32 r6, a6, b6;\n\t"
      "subc.cc.u32 r7, a7, b7;\n\t"
      "subc.cc.u32 r8, a8, b8;\n\t"
      "subc.cc.u32 r9, a9, b9;\n\t"
      "subc.cc.u32 r10, a10, b10;\n\t"
      "subc.cc.u32 r11, a11, b11;\n\t"
      "subc.cc.u32 r12, a12, b12;\n\t"
      "subc.cc.u32 r13, a13, b13;\n\t"
      "subc.cc.u32 r14, a14, b14;\n\t"
      "subc.cc.u32 r15, a15, b15;\n\t"
      "subc.cc.u32 %8, %18, %27;\n\t"
      "subc.u32 %9, %28, 0;\n\t"
      "mov.b64 %0, {r0, r1};\n\t"
      "mov.b64 %1, {r2, r3};\n\t"
      "mov.b64 %2, {r4, r5};\n\t"
      "mov.b64 %3, {r6, r7};\n\t"
      "mov.b64 %4, {r8, r9};\n\t"
      "mov.b64 %5, {r10, r11};\n\t"
      "mov.b64 %6, {r12, r13};\n\t"
      "mov.b64 %7, {r14, r15};\n\t"
      "}"
      : "=l"(rp[0]), "=l"(rp[1]), "=l"(rp[2]), "=l"(rp[3]), "=l"(rp[4]), "=l"(rp[5]),
        "=l"(rp[6]), "=l"(rp[7]), "=&r"(r.v[16]), "=r"(m)
      : "l"(pa[0]), "l"(pa[1]), "l"(pa[2]), "l"(pa[3]), "l"(pa[4]), "l"(pa[5]), "l"(pa[6]),
        "l"(pa[7]), "r"(a.v[16]), "l"(pb[0]), "l"(pb[1]), "l"(pb[2]), "l"(pb[3]), "l"(pb[4]),
        "l"(pb[5]), "l"(pb[6]), "l"(pb[7]), "r"(b.v[16]), "r"(x));
#pragma unroll
  for (int j = 0; j < 8; ++j) split(r.v, j, rp[j]);
  return m;
}

// The chain of each width, by overload.
__device__ __forceinline__ uint32_t add_chain(fe& r, const fe& a, const fe& b) {
  return add8(r, a, b);
}
__device__ __forceinline__ uint32_t add_chain(fe_t<12>& r, const fe_t<12>& a,
                                              const fe_t<12>& b) {
  return add12(r, a, b);
}
__device__ __forceinline__ uint32_t add_chain(fe_t<17>& r, const fe_t<17>& a,
                                              const fe_t<17>& b) {
  return add17(r, a, b);
}
__device__ __forceinline__ uint32_t sub_chain(fe& r, const fe& a, const fe& b, uint32_t x) {
  return sub8(r, a, b, x);
}
__device__ __forceinline__ uint32_t sub_chain(fe_t<12>& r, const fe_t<12>& a,
                                              const fe_t<12>& b, uint32_t x) {
  return sub12(r, a, b, x);
}
__device__ __forceinline__ uint32_t sub_chain(fe_t<17>& r, const fe_t<17>& a,
                                              const fe_t<17>& b, uint32_t x) {
  return sub17(r, a, b, x);
}

template <int N>
__device__ __forceinline__ fe_t<N> fe_words(const uint32_t* P) {
  fe_t<N> r;
#pragma unroll
  for (int j = 0; j < N; ++j) r.v[j] = P[j];
  return r;
}

// a - P if (carry or a >= P), else a: a is kept only where carry - borrow
// is -1 (no carry, a < P); its sign bit spread over the word is the mask.
// The result is canonical when a + carry * 2^(32N) < 2P.
template <int N>
__device__ __forceinline__ fe_t<N> fe_cond_sub(const fe_t<N>& a, uint32_t carry,
                                               const uint32_t* P) {
  fe_t<N> t;
  const uint32_t keep_a =
      (uint32_t)((int32_t)sub_chain(t, a, fe_words<N>(P), carry) >> 31);
  fe_t<N> r;
#pragma unroll
  for (int j = 0; j < N; ++j) r.v[j] = (a.v[j] & keep_a) | (t.v[j] & ~keep_a);
  return r;
}

// (a + b) mod P for a, b in [0, P).
template <int N>
__device__ __forceinline__ fe_t<N> fe_add_mod(const fe_t<N>& a, const fe_t<N>& b,
                                              const uint32_t* P) {
  fe_t<N> s;
  const uint32_t c = add_chain(s, a, b);
  return fe_cond_sub(s, c, P);
}

// (a - b) mod P for a, b in [0, P): a - b, then P added back where it
// borrowed (P & mask).
template <int N>
__device__ __forceinline__ fe_t<N> fe_sub_mod(const fe_t<N>& a, const fe_t<N>& b,
                                              const uint32_t* P) {
  fe_t<N> d, pm, r;
  const uint32_t m = sub_chain(d, a, b, 0u);
#pragma unroll
  for (int j = 0; j < N; ++j) pm.v[j] = P[j] & m;
  add_chain(r, d, pm);
  return r;
}

// (-a) mod P for a in [0, P); -0 = 0: P - a, masked to 0 where a == 0.
template <int N>
__device__ __forceinline__ fe_t<N> fe_neg_mod(const fe_t<N>& a, const uint32_t* P) {
  fe_t<N> d;
  sub_chain(d, fe_words<N>(P), a, 0u);
  const uint32_t nz = fe_is_zero(a) - 1u;  // all ones where a != 0
#pragma unroll
  for (int j = 0; j < N; ++j) d.v[j] &= nz;
  return d;
}

}  // namespace ec
