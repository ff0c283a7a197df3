// The N x N -> 2N-word multiply and the dedicated squaring of the P-384
// (N = 12) and P-521 (N = 17) field layers, for one lane per thread
// (sm_90a). The 8-word ones of the 256-bit fields are mul256.cuh's, which
// stay as they are.
//
// Replaces the digit grid of ecsimd_tpu/kernels/digits.py (and
// ops/bignum.py's product) at these widths. The multiply is
// product-scanning (Comba), mul256.cuh's mul_wide at width N: column k
// sums a_i b_j (i + j = k) into the three-word accumulator with mac() (one
// PTX chain a product: mad.lo.cc, madc.hi.cc, addc), 144 products at
// N = 12 and 289 at N = 17. The squaring takes the N (N - 1) / 2 cross
// products once by the same columns (66 and 136), doubles the 2N column
// words with funnel shifts (no carry chain: the triangle is below
// 2^(64N - 1)), then adds the N squares a_i^2 (one wide product each) at
// words 2i, 2i + 1, one four-instruction chain a square that takes the
// previous square's carry in (add.cc of carry and 2^32 - 1 sets the flag to
// it) and hands its own on: 78 and 153 products. The chains of mac() and of
// the squares have 8 operands each, and the squares are formed as wide
// products, not madc.lo chains (mul256.cuh: CUDA 12.8 gave wrong madc squares of compile-time
// constants). tests/test_torch_field_words.py transcribes both.
//
// What bounds them on the card: the multiply-add pipe (about one
// IMAD-class instruction a product) and the ALU pipe (each product's addc).

#pragma once

#include "limbs.cuh"
#include "mul256.cuh"

namespace ec {

// c[0 .. 2N-1] = a * b.
template <int N>
__device__ __forceinline__ void mul_wide_n(const fe_t<N>& a, const fe_t<N>& b,
                                           uint32_t c[2 * N]) {
  uint32_t c0 = 0u, c1 = 0u, c2 = 0u;
#pragma unroll
  for (int k = 0; k < 2 * N - 1; ++k) {
#pragma unroll
    for (int i = (k > N - 1 ? k - (N - 1) : 0); i <= (k < N - 1 ? k : N - 1); ++i) {
      mac(c0, c1, c2, a.v[i], b.v[k - i]);
    }
    c[k] = c0;
    c0 = c1;
    c1 = c2;
    c2 = 0u;
  }
  c[2 * N - 1] = c0;
}

// c[0 .. 2N-1] = a^2.
template <int N>
__device__ __forceinline__ void sqr_wide_n(const fe_t<N>& a, uint32_t c[2 * N]) {
  uint32_t t[2 * N];
  uint32_t c0 = 0u, c1 = 0u, c2 = 0u;
  t[0] = 0u;
#pragma unroll
  for (int k = 1; k < 2 * N - 2; ++k) {
#pragma unroll
    for (int i = (k > N - 1 ? k - (N - 1) : 0); i < (k + 1) / 2; ++i) {
      mac(c0, c1, c2, a.v[i], a.v[k - i]);
    }
    t[k] = c0;
    c0 = c1;
    c1 = c2;
    c2 = 0u;
  }
  t[2 * N - 2] = c0;
  t[2 * N - 1] = c1;
  // c = 2 t: word k takes t_k's low 31 bits and t_(k-1)'s top bit
  c[0] = 0u;
#pragma unroll
  for (int k = 1; k < 2 * N; ++k) c[k] = __funnelshift_l(t[k - 1], t[k], 1);
  // + a_i^2 at words 2i, 2i + 1, each chain taking the carry of the last
  uint32_t cy = 0u;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const uint64_t q = (uint64_t)a.v[i] * a.v[i];
    asm("{\n\t"
        ".reg .u32 f;\n\t"
        "add.cc.u32 f, %2, 0xFFFFFFFF;\n\t"
        "addc.cc.u32 %0, %0, %3;\n\t"
        "addc.cc.u32 %1, %1, %4;\n\t"
        "addc.u32 %2, 0, 0;\n\t"
        "}"
        : "+r"(c[2 * i]), "+r"(c[2 * i + 1]), "+r"(cy)
        : "r"((uint32_t)q), "r"((uint32_t)(q >> 32)));
  }
}

}  // namespace ec
