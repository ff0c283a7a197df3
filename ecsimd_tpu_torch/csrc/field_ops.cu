// Kernel C: field-operation probe, one lane per thread (NVIDIA Hopper,
// sm_90a), on P-256 (field_p256.cuh, Solinas), on secp256k1
// (field_secp256k1.cuh, Montgomery, R = 2^256), on 2^255 - 19
// (field_w25519.cuh, Crandall fold), on P-384 (field_p384.cuh, Solinas)
// and on P-521 (field_p521.cuh, the Mersenne fold).
//
// Runs mul, sqr, add, sub and opposite of a field layer on (D, B) digit
// planes, so that a disagreement with the plain PyTorch GFp can be told
// apart from a disagreement in the Jacobian formulas. Its TPU counterpart is
// the interpret-mode harness of tests/test_kernels.py:_run_binop, which
// runs ecsimd_tpu/kernels/digits.py field ops inside a Pallas kernel. The
// planes are the field's internal form (Montgomery form for secp256k1), as
// GFp holds them.
//
// What bounds it: memory traffic (7 planes of D words per lane against
// about 150 multiply-adds at 16 digits); it exists for correctness, not
// speed.

#include "field_p256.cuh"
#include "field_p384.cuh"
#include "field_p521.cuh"
#include "field_secp256k1.cuh"
#include "field_w25519.cuh"

namespace {

// out holds 5 consecutive (D, B) planes: a*b, a^2, a+b, a-b, -a.
#define EC_FIELD_PROBE_KERNEL(NAME, NS)                                                   \
  __global__ void NAME(const int32_t* __restrict__ a_planes,                              \
                       const int32_t* __restrict__ b_planes, int32_t* __restrict__ out,   \
                       int64_t B) {                                                       \
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;                     \
    if (i >= B) return;                                                                   \
    const NS::fe a = NS::fe_load(a_planes, B, i);                                         \
    const NS::fe b = NS::fe_load(b_planes, B, i);                                         \
    const int64_t plane = NS::kDigits * B;                                                \
    NS::fe_store(out, B, i, NS::fe_mul(a, b));                                            \
    NS::fe_store(out + plane, B, i, NS::fe_sqr(a));                                       \
    NS::fe_store(out + 2 * plane, B, i, NS::fe_add(a, b));                                \
    NS::fe_store(out + 3 * plane, B, i, NS::fe_sub(a, b));                                \
    NS::fe_store(out + 4 * plane, B, i, NS::fe_neg(a));                                   \
  }

EC_FIELD_PROBE_KERNEL(field_probe_p256_kernel, p256)
EC_FIELD_PROBE_KERNEL(field_probe_secp256k1_kernel, secp256k1)
EC_FIELD_PROBE_KERNEL(field_probe_w25519_kernel, w25519)
EC_FIELD_PROBE_KERNEL(field_probe_p384_kernel, p384)
EC_FIELD_PROBE_KERNEL(field_probe_p521_kernel, p521)

constexpr int kThreads = 256;

// The same operations on compile-time constants (1, 2, p - 1, 0), so that
// the constants reach the inlined asm chains as the formulas' fe_one() and
// curve_a() do (a CUDA 12.8 ptxas gave wrong madc squares of such
// constants, mul256.cuh): one lane, out (CONST_OPS, D, 1). The P-384 and
// P-521 layers.
#define EC_FIELD_CONSTS_KERNEL(NAME, NS)                                                   \
  __global__ void NAME(int32_t* __restrict__ out) {                                       \
    const NS::fe one = NS::fe_one(), zero = NS::fe_zero(), two = NS::fe_from_u32(2u);      \
    const NS::fe pm1 = NS::fe_neg(one);                                                    \
    const NS::fe r[] = {NS::fe_add(pm1, one),  NS::fe_add(pm1, pm1), NS::fe_sub(one, pm1), \
                        NS::fe_sub(zero, one), NS::fe_neg(zero),     NS::fe_mul(pm1, pm1), \
                        NS::fe_sqr(pm1),       NS::fe_sqr(one),      NS::fe_mul(one, two), \
                        NS::fe_dbl(pm1)};                                                  \
    for (int k = 0; k < (int)(sizeof(r) / sizeof(r[0])); ++k) {                            \
      NS::fe_store(out + k * NS::kDigits, 1, 0, r[k]);                                     \
    }                                                                                      \
  }

EC_FIELD_CONSTS_KERNEL(field_consts_p384_kernel, p384)
EC_FIELD_CONSTS_KERNEL(field_consts_p521_kernel, p521)

}  // namespace

// a, b: (D, B) int32 digit planes; out: (5, D, B). Launches on `stream`
// and returns cudaGetLastError().
extern "C" int ec_field_probe_p256(const int32_t* a, const int32_t* b, int32_t* out,
                                   int64_t B, void* stream) {
  if (B > 0) {
    const int64_t blocks = (B + kThreads - 1) / kThreads;
    field_probe_p256_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(a, b, out, B);
  }
  return (int)cudaGetLastError();
}

extern "C" int ec_field_probe_secp256k1(const int32_t* a, const int32_t* b, int32_t* out,
                                        int64_t B, void* stream) {
  if (B > 0) {
    const int64_t blocks = (B + kThreads - 1) / kThreads;
    field_probe_secp256k1_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        a, b, out, B);
  }
  return (int)cudaGetLastError();
}

extern "C" int ec_field_probe_w25519(const int32_t* a, const int32_t* b, int32_t* out,
                                     int64_t B, void* stream) {
  if (B > 0) {
    const int64_t blocks = (B + kThreads - 1) / kThreads;
    field_probe_w25519_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        a, b, out, B);
  }
  return (int)cudaGetLastError();
}

extern "C" int ec_field_probe_p384(const int32_t* a, const int32_t* b, int32_t* out,
                                   int64_t B, void* stream) {
  if (B > 0) {
    const int64_t blocks = (B + kThreads - 1) / kThreads;
    field_probe_p384_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(a, b, out, B);
  }
  return (int)cudaGetLastError();
}

extern "C" int ec_field_probe_p521(const int32_t* a, const int32_t* b, int32_t* out,
                                   int64_t B, void* stream) {
  if (B > 0) {
    const int64_t blocks = (B + kThreads - 1) / kThreads;
    field_probe_p521_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(a, b, out, B);
  }
  return (int)cudaGetLastError();
}

// out: (10, D, 1) int32: 1 + (p - 1), 2 (p - 1), 1 - (p - 1), 0 - 1, -0,
// (p - 1)^2, (p - 1)^2 by squaring, 1^2, 1 * 2, 2 (p - 1), each on
// compile-time constants. Launches on `stream` and returns
// cudaGetLastError().
extern "C" int ec_field_consts_p384(int32_t* out, int64_t B, void* stream) {
  if (B > 0) field_consts_p384_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(out);
  return (int)cudaGetLastError();
}

extern "C" int ec_field_consts_p521(int32_t* out, int64_t B, void* stream) {
  if (B > 0) field_consts_p521_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(out);
  return (int)cudaGetLastError();
}
