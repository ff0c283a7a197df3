// The 256 x 256 -> 512-bit multiply and the dedicated squaring shared by the
// P-256 and secp256k1 field layers (field_p256.cuh, field_secp256k1.cuh),
// for one lane per thread (sm_90a).
//
// The multiply is product-scanning (Comba): column k of the 8 x 8 grid sums
// the products a_i b_j with i + j = k into a three-word accumulator
// (c0, c1, c2), writes c0 out, and shifts the accumulator down one word.
// Each product is one PTX carry chain of its own — mad.lo.cc into c0,
// madc.hi.cc into c1, addc into c2 — so no carry flag has to live across
// two asm statements. The top word takes the carries of at most 8 products
// and the carry-in, so it stays below 16.
//
// The squaring takes the 28 cross products a_i a_j (i < j) once, by the
// same columns, then doubles the 16 column words in one add chain and adds
// the 8 squares a_i^2 (at words 2i, 2i + 1) in two: 36 products where the
// multiply takes 64. The cross products sum below 2^511, so the doubling
// carries nothing out.
//
// tests/test_torch_field_words.py transcribes both, instruction for
// instruction, and holds them to Python ints.
//
// What bounds them on the card: the integer pipes. In SASS a product
// costs about one IMAD-class instruction: a P-256 doubling (3 multiplies
// and 5 squarings, 372 products) is 433 IMAD-class and 1,628 ALU
// instructions (bench/sass.py, CUDA 12.8), the ALU taking the top word's
// addc, every carry chain of the reductions and the formulas' adds — the
// busier pipe. The tensor cores do not apply: the two operands are
// lane-specific, not a matrix.

#pragma once

#include "limbs.cuh"

namespace ec {

// (c0, c1, c2) += a * b.
__device__ __forceinline__ void mac(uint32_t& c0, uint32_t& c1, uint32_t& c2, uint32_t a,
                                    uint32_t b) {
  asm("mad.lo.cc.u32 %0, %3, %4, %0;\n\t"
      "madc.hi.cc.u32 %1, %3, %4, %1;\n\t"
      "addc.u32 %2, %2, 0;"
      : "+r"(c0), "+r"(c1), "+r"(c2)
      : "r"(a), "r"(b));
}

// c[0..15] = a * b.
__device__ __forceinline__ void mul_wide(const fe& a, const fe& b, uint32_t c[16]) {
  uint32_t c0 = 0u, c1 = 0u, c2 = 0u;
#pragma unroll
  for (int k = 0; k < 15; ++k) {
#pragma unroll
    for (int i = (k > 7 ? k - 7 : 0); i <= (k < 7 ? k : 7); ++i) {
      mac(c0, c1, c2, a.v[i], b.v[k - i]);
    }
    c[k] = c0;
    c0 = c1;
    c1 = c2;
    c2 = 0u;
  }
  c[15] = c0;
}

// c[0..15] = a^2.
__device__ __forceinline__ void sqr_wide(const fe& a, uint32_t c[16]) {
  uint32_t t[16];
  uint32_t c0 = 0u, c1 = 0u, c2 = 0u;
  t[0] = 0u;
#pragma unroll
  for (int k = 1; k < 14; ++k) {
#pragma unroll
    for (int i = (k > 7 ? k - 7 : 0); i < (k + 1) / 2; ++i) {
      mac(c0, c1, c2, a.v[i], a.v[k - i]);
    }
    t[k] = c0;
    c0 = c1;
    c1 = c2;
    c2 = 0u;
  }
  t[14] = c0;
  t[15] = c1;
  // d = 2 t (t[0] = 0)
  uint32_t d[16];
  d[0] = 0u;
  asm("add.cc.u32 %0, %15, %15;\n\t"
      "addc.cc.u32 %1, %16, %16;\n\t"
      "addc.cc.u32 %2, %17, %17;\n\t"
      "addc.cc.u32 %3, %18, %18;\n\t"
      "addc.cc.u32 %4, %19, %19;\n\t"
      "addc.cc.u32 %5, %20, %20;\n\t"
      "addc.cc.u32 %6, %21, %21;\n\t"
      "addc.cc.u32 %7, %22, %22;\n\t"
      "addc.cc.u32 %8, %23, %23;\n\t"
      "addc.cc.u32 %9, %24, %24;\n\t"
      "addc.cc.u32 %10, %25, %25;\n\t"
      "addc.cc.u32 %11, %26, %26;\n\t"
      "addc.cc.u32 %12, %27, %27;\n\t"
      "addc.cc.u32 %13, %28, %28;\n\t"
      "addc.u32 %14, %29, %29;"
      : "=r"(d[1]), "=r"(d[2]), "=r"(d[3]), "=r"(d[4]), "=r"(d[5]), "=r"(d[6]), "=r"(d[7]),
        "=r"(d[8]), "=r"(d[9]), "=r"(d[10]), "=r"(d[11]), "=r"(d[12]), "=r"(d[13]),
        "=r"(d[14]), "=r"(d[15])
      : "r"(t[1]), "r"(t[2]), "r"(t[3]), "r"(t[4]), "r"(t[5]), "r"(t[6]), "r"(t[7]),
        "r"(t[8]), "r"(t[9]), "r"(t[10]), "r"(t[11]), "r"(t[12]), "r"(t[13]), "r"(t[14]),
        "r"(t[15]));
  // c = d + the squares: s = a_i^2 at words 2i, 2i + 1 (one wide product
  // each), added in two chains of at most 30 operands; the carry out of
  // word 8 goes into s[9], the high word of a_4^2 (at most 2^32 - 2, so it
  // does not overflow). A chain of madc.lo / madc.hi in place of the wide
  // products and the adds gave wrong squares of compile-time constants on
  // the card (fe_sqr(fe_one()), CUDA 12.8), though right ones of loaded
  // values; this form is right for both.
  uint32_t s[16];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint64_t q = (uint64_t)a.v[i] * a.v[i];
    s[2 * i] = (uint32_t)q;
    s[2 * i + 1] = (uint32_t)(q >> 32);
  }
  uint32_t cy;
  asm("add.cc.u32 %0, %10, %19;\n\t"
      "addc.cc.u32 %1, %11, %20;\n\t"
      "addc.cc.u32 %2, %12, %21;\n\t"
      "addc.cc.u32 %3, %13, %22;\n\t"
      "addc.cc.u32 %4, %14, %23;\n\t"
      "addc.cc.u32 %5, %15, %24;\n\t"
      "addc.cc.u32 %6, %16, %25;\n\t"
      "addc.cc.u32 %7, %17, %26;\n\t"
      "addc.cc.u32 %8, %18, %27;\n\t"
      "addc.u32 %9, 0, 0;"
      : "=r"(c[0]), "=r"(c[1]), "=r"(c[2]), "=r"(c[3]), "=r"(c[4]), "=r"(c[5]), "=r"(c[6]),
        "=r"(c[7]), "=r"(c[8]), "=r"(cy)
      : "r"(d[0]), "r"(d[1]), "r"(d[2]), "r"(d[3]), "r"(d[4]), "r"(d[5]), "r"(d[6]), "r"(d[7]),
        "r"(d[8]), "r"(s[0]), "r"(s[1]), "r"(s[2]), "r"(s[3]), "r"(s[4]), "r"(s[5]), "r"(s[6]),
        "r"(s[7]), "r"(s[8]));
  asm("add.cc.u32 %0, %7, %14;\n\t"
      "addc.cc.u32 %1, %8, %15;\n\t"
      "addc.cc.u32 %2, %9, %16;\n\t"
      "addc.cc.u32 %3, %10, %17;\n\t"
      "addc.cc.u32 %4, %11, %18;\n\t"
      "addc.cc.u32 %5, %12, %19;\n\t"
      "addc.u32 %6, %13, %20;"
      : "=r"(c[9]), "=r"(c[10]), "=r"(c[11]), "=r"(c[12]), "=r"(c[13]), "=r"(c[14]), "=r"(c[15])
      : "r"(d[9]), "r"(d[10]), "r"(d[11]), "r"(d[12]), "r"(d[13]), "r"(d[14]), "r"(d[15]),
        "r"(s[9] + cy), "r"(s[10]), "r"(s[11]), "r"(s[12]), "r"(s[13]), "r"(s[14]), "r"(s[15]));
}

}  // namespace ec
