// Kernel C: field-operation probe, one lane per thread (NVIDIA Hopper,
// sm_90a), on P-256 (field_p256.cuh, Solinas), on secp256k1
// (field_secp256k1.cuh, Montgomery, R = 2^256) and on 2^255 - 19
// (field_w25519.cuh, Crandall fold).
//
// Runs mul, sqr, add, sub and opposite of a field layer on (16, B) digit
// planes, so that a disagreement with the plain PyTorch GFp can be told
// apart from a disagreement in the Jacobian formulas. Its TPU counterpart is
// the interpret-mode harness of tests/test_kernels.py:_run_binop, which
// runs ecsimd_tpu/kernels/digits.py field ops inside a Pallas kernel. The
// planes are the field's internal form (Montgomery form for secp256k1), as
// GFp holds them.
//
// What bounds it: memory traffic (7 planes of 16 words per lane against
// about 150 multiply-adds); it exists for correctness, not speed.

#include "field_p256.cuh"
#include "field_secp256k1.cuh"
#include "field_w25519.cuh"

namespace {

// out holds 5 consecutive (16, B) planes: a*b, a^2, a+b, a-b, -a.
#define EC_FIELD_PROBE_KERNEL(NAME, NS)                                                   \
  __global__ void NAME(const int32_t* __restrict__ a_planes,                              \
                       const int32_t* __restrict__ b_planes, int32_t* __restrict__ out,   \
                       int64_t B) {                                                       \
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;                     \
    if (i >= B) return;                                                                   \
    const NS::fe a = NS::fe_load(a_planes, B, i);                                         \
    const NS::fe b = NS::fe_load(b_planes, B, i);                                         \
    const int64_t plane = 16 * B;                                                         \
    NS::fe_store(out, B, i, NS::fe_mul(a, b));                                            \
    NS::fe_store(out + plane, B, i, NS::fe_sqr(a));                                       \
    NS::fe_store(out + 2 * plane, B, i, NS::fe_add(a, b));                                \
    NS::fe_store(out + 3 * plane, B, i, NS::fe_sub(a, b));                                \
    NS::fe_store(out + 4 * plane, B, i, NS::fe_neg(a));                                   \
  }

EC_FIELD_PROBE_KERNEL(field_probe_p256_kernel, p256)
EC_FIELD_PROBE_KERNEL(field_probe_secp256k1_kernel, secp256k1)
EC_FIELD_PROBE_KERNEL(field_probe_w25519_kernel, w25519)

constexpr int kThreads = 256;

}  // namespace

// a, b: (16, B) int32 digit planes; out: (5, 16, B). Launches on `stream`
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
