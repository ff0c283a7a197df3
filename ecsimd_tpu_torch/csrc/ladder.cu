// Kernel A: the co-Z masked-swap ladder k_i * P_i on P-256, secp256k1 and
// Wei25519, one lane per thread (NVIDIA Hopper, sm_90a).
//
// Replaces ecsimd_tpu/kernels/ladder.py:_ladder_kernel (core _ladder_core),
// which the JAX package runs on every curve. Same formula sequence as
// curves/group.scalar_mult: TPLU seed (3P, P), swap on bit 1, then for bits
// 2..255 swap on the bit, ZDAU, swap again; finally ADD_Z2_1(acc, (x, -y))
// selected on even lanes (ladder_lane.cuh, over coz.cuh's formulas with the
// curve's a). Input coordinates and output Jacobian (X, Y, Z) planes are in
// the field's internal form (Montgomery form on secp256k1), bit-identical
// to the plain PyTorch version.
//
// What bounds it: the integer ALU pipe. A P-256 lane issues 1.1 M
// instructions, 72 % ALU (the field layer's carry chains and the formulas'
// adds) and 23 % IMAD, in 254 ZDAU steps of 16 field multiplies with
// nothing to read from memory in the loop (bench/sass.py; secp256k1 and
// Wei25519 55 % and 51 % ALU). The whole ladder state (two co-Z points and
// the shared Z, 40 words) stays in registers for all 254 steps, and each
// 32-bit scalar word is read from global memory once per 32 bits; masked
// swaps keep control flow uniform across the warp (and constant-time per
// lane). Lanes past the end of the batch return at once (i < B), so the
// batch needs no padding.

#include "coz_p256.cuh"
#include "coz_secp256k1.cuh"
#include "coz_w25519.cuh"

namespace p256 {
#include "ladder_lane.cuh"
}  // namespace p256

namespace secp256k1 {
#include "ladder_lane.cuh"
}  // namespace secp256k1

namespace w25519 {
#include "ladder_lane.cuh"
}  // namespace w25519

namespace {

constexpr int kThreads = 128;

// The launch bounds a curve (after NS: the threads, then the least blocks
// an SM ptxas must leave registers for), by the card's times (PERF.md):
// P-256 at ptxas's own budget (128 registers; at a bound of four blocks it
// ran 0.7 % slower), secp256k1 and Wei25519 at four blocks (128 registers,
// a few spill stores a step, yet faster than three or ptxas's 156 / 168).
#define EC_LADDER_KERNEL(NAME, NS, ...)                                                    \
  __global__ void __launch_bounds__(__VA_ARGS__)                                           \
  NAME(const int32_t* __restrict__ scalars, const int32_t* __restrict__ xs,                \
       const int32_t* __restrict__ ys, int32_t* __restrict__ ax, int32_t* __restrict__ ay,  \
       int32_t* __restrict__ z, int64_t B) {                                               \
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;                      \
    if (i >= B) return;                                                                    \
    NS::ladder_lane(scalars, xs, ys, ax, ay, z, B, i);                                     \
  }

EC_LADDER_KERNEL(ladder_p256_kernel, p256, kThreads)
EC_LADDER_KERNEL(ladder_secp256k1_kernel, secp256k1, kThreads, 4)
EC_LADDER_KERNEL(ladder_w25519_kernel, w25519, kThreads, 4)

template <class Kernel>
int launch(Kernel kernel, const int32_t* scalars, const int32_t* xs, const int32_t* ys,
           int32_t* ax, int32_t* ay, int32_t* z, int64_t B, void* stream) {
  if (B > 0) {
    const int64_t blocks = (B + kThreads - 1) / kThreads;
    kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(scalars, xs, ys, ax, ay,
                                                                      z, B);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// scalars: (16, B) int32 classical digit planes; xs, ys: (16, B) affine
// coordinates in the field's internal form; ax, ay, z: (16, B) outputs.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int ec_ladder_p256(const int32_t* scalars, const int32_t* xs, const int32_t* ys,
                              int32_t* ax, int32_t* ay, int32_t* z, int64_t B,
                              void* stream) {
  return launch(ladder_p256_kernel, scalars, xs, ys, ax, ay, z, B, stream);
}

extern "C" int ec_ladder_secp256k1(const int32_t* scalars, const int32_t* xs,
                                   const int32_t* ys, int32_t* ax, int32_t* ay, int32_t* z,
                                   int64_t B, void* stream) {
  return launch(ladder_secp256k1_kernel, scalars, xs, ys, ax, ay, z, B, stream);
}

extern "C" int ec_ladder_w25519(const int32_t* scalars, const int32_t* xs, const int32_t* ys,
                                int32_t* ax, int32_t* ay, int32_t* z, int64_t B,
                                void* stream) {
  return launch(ladder_w25519_kernel, scalars, xs, ys, ax, ay, z, B, stream);
}
