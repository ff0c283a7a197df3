// Kernel D: Jacobian -> affine on P-256, secp256k1, Wei25519, P-384 and
// P-521, one lane per thread (NVIDIA Hopper, sm_90a).
//
// Replaces the affine conversion at the end of the JAX package's API,
// ecsimd_tpu/curves/point.py:JacobianPoint.to_affine, which runs as plain
// XLA there (no Pallas kernel). Its plain PyTorch version,
// curves/point.py:JacobianPoint.to_affine, shares one inversion across the
// batch through a product tree (GFp.batch_inverse), which eager PyTorch
// runs as thousands of small launches. Here every lane inverts its own z
// with the Fermat power z^(p-2) (fe_inv), then forms x / z^2 and y / z^3 and
// converts them to classical residues (a Montgomery multiply by 1 on
// secp256k1, nothing on P-256). inverse(0) = 0, so a lane at infinity gives
// (0, 0), as in the plain version; the residues are canonical, so both
// agree bit for bit.
//
// What bounds it: 32-bit integer multiply-add throughput, about 387 field
// multiplies per lane on P-256, 510 on secp256k1 (p - 2 has 249 set bits)
// and 270 on Wei25519 (the 2^255 - 19 addition chain); on P-384 and P-521
// the addition chains of field_p384.cuh and field_p521.cuh, 403 and 541
// field operations of 144 / 78 and 289 / 153 products; memory traffic is
// five planes of D words per lane. Constant time per lane: the exponent is
// public and the same for every lane.

#include "field_p256.cuh"
#include "field_p384.cuh"
#include "field_p521.cuh"
#include "field_secp256k1.cuh"
#include "field_w25519.cuh"

namespace {

constexpr int kThreads = 128;

#define EC_AFFINE_KERNEL(NAME, NS)                                                         \
  __global__ void __launch_bounds__(kThreads)                                              \
  NAME(const int32_t* __restrict__ xs, const int32_t* __restrict__ ys,                     \
       const int32_t* __restrict__ zs, int32_t* __restrict__ ax, int32_t* __restrict__ ay, \
       int64_t B) {                                                                        \
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;                      \
    if (i >= B) return;                                                                    \
    const NS::fe zi = NS::fe_inv(NS::fe_load(zs, B, i));                                   \
    const NS::fe zi2 = NS::fe_sqr(zi);                                                     \
    NS::fe_store(ax, B, i, NS::fe_to_classical(NS::fe_mul(NS::fe_load(xs, B, i), zi2)));   \
    NS::fe_store(ay, B, i,                                                                 \
                 NS::fe_to_classical(NS::fe_mul(NS::fe_mul(NS::fe_load(ys, B, i), zi2), zi))); \
  }

EC_AFFINE_KERNEL(affine_p256_kernel, p256)
EC_AFFINE_KERNEL(affine_secp256k1_kernel, secp256k1)
EC_AFFINE_KERNEL(affine_w25519_kernel, w25519)
EC_AFFINE_KERNEL(affine_p384_kernel, p384)
EC_AFFINE_KERNEL(affine_p521_kernel, p521)

template <class Kernel>
int launch(Kernel kernel, const int32_t* xs, const int32_t* ys, const int32_t* zs, int32_t* ax,
           int32_t* ay, int64_t B, void* stream) {
  if (B > 0) {
    const int64_t blocks = (B + kThreads - 1) / kThreads;
    kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(xs, ys, zs, ax, ay, B);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// xs, ys, zs: (D, B) int32 Jacobian digit planes (internal form; D = 16,
// or 24 on P-384 and 33 on P-521); ax, ay: (D, B) classical affine outputs. Launches on `stream` and returns
// cudaGetLastError().
extern "C" int ec_affine_p256(const int32_t* xs, const int32_t* ys, const int32_t* zs,
                              int32_t* ax, int32_t* ay, int64_t B, void* stream) {
  return launch(affine_p256_kernel, xs, ys, zs, ax, ay, B, stream);
}

extern "C" int ec_affine_secp256k1(const int32_t* xs, const int32_t* ys, const int32_t* zs,
                                   int32_t* ax, int32_t* ay, int64_t B, void* stream) {
  return launch(affine_secp256k1_kernel, xs, ys, zs, ax, ay, B, stream);
}

extern "C" int ec_affine_w25519(const int32_t* xs, const int32_t* ys, const int32_t* zs,
                                int32_t* ax, int32_t* ay, int64_t B, void* stream) {
  return launch(affine_w25519_kernel, xs, ys, zs, ax, ay, B, stream);
}

extern "C" int ec_affine_p384(const int32_t* xs, const int32_t* ys, const int32_t* zs,
                              int32_t* ax, int32_t* ay, int64_t B, void* stream) {
  return launch(affine_p384_kernel, xs, ys, zs, ax, ay, B, stream);
}

extern "C" int ec_affine_p521(const int32_t* xs, const int32_t* ys, const int32_t* zs,
                              int32_t* ax, int32_t* ay, int64_t B, void* stream) {
  return launch(affine_p521_kernel, xs, ys, zs, ax, ay, B, stream);
}
