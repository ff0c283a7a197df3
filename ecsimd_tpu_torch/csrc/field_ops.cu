// Kernel C: P-256 field-operation probe, one lane per thread (NVIDIA Hopper,
// sm_90a).
//
// Runs mul, sqr, add, sub and opposite from field_p256.cuh on (16, B) digit
// planes, so that a disagreement with the plain PyTorch GFp can be told
// apart from a disagreement in the co-Z formulas. Its TPU counterpart is
// the interpret-mode harness of tests/test_kernels.py:_run_binop, which
// runs ecsimd_tpu/kernels/digits.py field ops inside a Pallas kernel.
//
// What bounds it: memory traffic (7 planes of 16 words per lane against
// about 150 multiply-adds); it exists for correctness, not speed.

#include "field_p256.cuh"

namespace p256 {

// out holds 5 consecutive (16, B) planes: a*b, a^2, a+b, a-b, -a.
__device__ __forceinline__ void field_probe_lane(const int32_t* a_planes,
                                                 const int32_t* b_planes, int32_t* out,
                                                 int64_t B, int64_t i) {
  const fe a = fe_load(a_planes, B, i);
  const fe b = fe_load(b_planes, B, i);
  const int64_t plane = 16 * B;
  fe_store(out, B, i, fe_mul(a, b));
  fe_store(out + plane, B, i, fe_sqr(a));
  fe_store(out + 2 * plane, B, i, fe_add(a, b));
  fe_store(out + 3 * plane, B, i, fe_sub(a, b));
  fe_store(out + 4 * plane, B, i, fe_neg(a));
}

}  // namespace p256

namespace {

constexpr int kThreads = 256;

__global__ void field_probe_p256_kernel(const int32_t* __restrict__ a,
                                        const int32_t* __restrict__ b,
                                        int32_t* __restrict__ out, int64_t B) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  p256::field_probe_lane(a, b, out, B, i);
}

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
