// Kernel G: the x-only Montgomery ladder of RFC 7748 X25519, and kernel H:
// x / z, one lane per thread (NVIDIA Hopper, sm_90a).
//
// Kernel G replaces ecsimd_tpu/kernels/mladder.py:_mladder_kernel (core
// _mladder_core) for X25519's instance: the 2^255 - 19 field, a24 = 121665,
// bits 254..0 of a clamped scalar. Per bit: the deferred conditional swap
// of (x2, z2) and (x3, z3) on swap ^ k_t, by masks, then the RFC 7748 §5
// step (5 multiplies, 4 squarings and one multiply by a24); after the last
// bit, the final swap. The state (x2, z2, x3, z3, swap) stays in registers
// for all 255 steps, and the loop stays rolled. It writes the projective
// (x2, z2), as the JAX mladder_planes returns them, so that it is held bit
// for bit against kernels/mladder.mladder_plain (every field result is
// canonical).
//
// Kernel H replaces the batch inversion of the JAX package's X25519
// epilogue (ecsimd_tpu/x25519.py, GFp.batch_inverse, plain XLA): each lane
// forms x2 z2^(p-2) with the addition chain of field_w25519.cuh (254
// squarings, 12 multiplies). z2 = 0 gives 0, as the batch inversion does.
//
// Constant time: no branch and no address depends on the scalar; the bit
// of step t is read from digit plane t / 16, an address fixed by the
// public loop counter.
//
// What bounds them: 32-bit integer multiply-adds. Kernel G: 255 x (5 M +
// 4 S + a24) per lane; kernel H: 12 M + 254 S. Memory: four planes of 16
// words per lane (G), three (H).

#include "field_w25519.cuh"

namespace {

constexpr int kThreads = 128;
constexpr uint32_t kA24 = 121665u;  // (486662 - 2) / 4
constexpr int kBits = 255;          // scanned bits of a clamped scalar

__global__ void __launch_bounds__(kThreads)
mladder_w25519_kernel(const int32_t* __restrict__ scalars, const int32_t* __restrict__ us,
                      int32_t* __restrict__ x_out, int32_t* __restrict__ z_out, int64_t B) {
  using namespace w25519;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  const fe u = fe_load(us, B, i);
  fe x2 = fe_one(), z2 = fe_zero(), x3 = u, z3 = fe_one();
  uint32_t swap = 0u;
#pragma unroll 1
  for (int t = kBits - 1; t >= 0; --t) {
    const uint32_t kt = ((uint32_t)__ldg(scalars + (t >> 4) * B + i) >> (t & 15)) & 1u;
    const uint32_t sw = swap ^ kt;
    fe_swap_if(sw, x2, x3);
    fe_swap_if(sw, z2, z3);
    const fe a = fe_add(x2, z2);
    const fe aa = fe_sqr(a);
    const fe b = fe_sub(x2, z2);
    const fe bb = fe_sqr(b);
    const fe e = fe_sub(aa, bb);
    const fe c = fe_add(x3, z3);
    const fe d = fe_sub(x3, z3);
    const fe da = fe_mul(d, a);
    const fe cb = fe_mul(c, b);
    x3 = fe_sqr(fe_add(da, cb));
    z3 = fe_mul(u, fe_sqr(fe_sub(da, cb)));
    x2 = fe_mul(aa, bb);
    z2 = fe_mul(e, fe_add(aa, fe_mul_small(e, kA24)));
    swap = kt;
  }
  fe_swap_if(swap, x2, x3);
  fe_swap_if(swap, z2, z3);
  fe_store(x_out, B, i, x2);
  fe_store(z_out, B, i, z2);
}

__global__ void __launch_bounds__(kThreads)
xdivz_w25519_kernel(const int32_t* __restrict__ xs, const int32_t* __restrict__ zs,
                    int32_t* __restrict__ out, int64_t B) {
  using namespace w25519;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  fe_store(out, B, i, fe_mul(fe_load(xs, B, i), fe_inv(fe_load(zs, B, i))));
}

}  // namespace

// scalars, us: (16, B) int32 digit planes (clamped scalars; u < p); x2, z2:
// (16, B) outputs. Launches on `stream` and returns cudaGetLastError().
extern "C" int ec_mladder_w25519(const int32_t* scalars, const int32_t* us, int32_t* x2,
                                 int32_t* z2, int64_t B, void* stream) {
  if (B > 0) {
    const int64_t blocks = (B + kThreads - 1) / kThreads;
    mladder_w25519_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        scalars, us, x2, z2, B);
  }
  return (int)cudaGetLastError();
}

// x2, z2: (16, B) int32 digit planes; out: (16, B) x2 / z2. Launches on
// `stream` and returns cudaGetLastError().
extern "C" int ec_xdivz_w25519(const int32_t* x2, const int32_t* z2, int32_t* out, int64_t B,
                               void* stream) {
  if (B > 0) {
    const int64_t blocks = (B + kThreads - 1) / kThreads;
    xdivz_w25519_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(x2, z2, out, B);
  }
  return (int)cudaGetLastError();
}
