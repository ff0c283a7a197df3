// Kernel D: Jacobian -> affine on P-256, one lane per thread (NVIDIA Hopper,
// sm_90a).
//
// Replaces the affine conversion at the end of the JAX package's API,
// ecsimd_tpu/curves/point.py:JacobianPoint.to_affine, which runs as plain
// XLA there (no Pallas kernel). Its plain PyTorch version,
// curves/point.py:JacobianPoint.to_affine, shares one inversion across the
// batch through a product tree (GFp.batch_inverse), which eager PyTorch
// runs as thousands of small launches. Here every lane inverts its own z
// with the Fermat power z^(p-2) (fe_inv), then forms x / z^2 and y / z^3.
// inverse(0) = 0, so a lane at infinity gives (0, 0), as in the plain
// version; the residues are canonical, so both agree bit for bit.
//
// What bounds it: 32-bit integer multiply-add throughput, about 387 field
// multiplies per lane (the comb's chain is 384); memory traffic is five
// planes of 16 words per lane. Constant time per lane: the exponent is
// public and the same for every lane.

#include "field_p256.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
affine_p256_kernel(const int32_t* __restrict__ xs, const int32_t* __restrict__ ys,
                   const int32_t* __restrict__ zs, int32_t* __restrict__ ax,
                   int32_t* __restrict__ ay, int64_t B) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  const p256::fe zi = p256::fe_inv(p256::fe_load(zs, B, i));
  const p256::fe zi2 = p256::fe_sqr(zi);
  p256::fe_store(ax, B, i, p256::fe_mul(p256::fe_load(xs, B, i), zi2));
  p256::fe_store(ay, B, i, p256::fe_mul(p256::fe_mul(p256::fe_load(ys, B, i), zi2), zi));
}

}  // namespace

// xs, ys, zs: (16, B) int32 Jacobian digit planes; ax, ay: (16, B) affine
// outputs. Launches on `stream` and returns cudaGetLastError().
extern "C" int ec_affine_p256(const int32_t* xs, const int32_t* ys, const int32_t* zs,
                              int32_t* ax, int32_t* ay, int64_t B, void* stream) {
  if (B > 0) {
    const int64_t blocks = (B + kThreads - 1) / kThreads;
    affine_p256_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        xs, ys, zs, ax, ay, B);
  }
  return (int)cudaGetLastError();
}
