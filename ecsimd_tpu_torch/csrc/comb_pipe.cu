// Kernel K: the fixed-base comb's serial chain, software-pipelined, on
// P-256, secp256k1 and Wei25519, one lane per thread (NVIDIA Hopper,
// sm_90a); the lane is comb_pipe_lane.cuh's, written once over the field's
// namespace.
//
// Replaces ecsimd_tpu/kernels/comb.py:_comb_kernel_pipe (chain="pipe"). The
// TPU kernel gathers entry j + 1 on its matrix unit (a one-hot product)
// while its vector unit adds entry j. Here the gather is the masked scan
// (comb_scan.cuh) of a position staged in shared memory (shared-memory
// loads and masked ORs: the load/store and integer-logic pipes), and the add is the
// field arithmetic (the multiply-add pipe). So iteration j reads entry
// j + 1 out of its staged position into registers and adds entry j, read
// in the iteration before: the two have no data dependence, and the warp
// schedulers can issue one warp's scan beside another warp's multiplies.
// Position j + 2 is copied into shared memory meanwhile (cp.async, double
// buffered). The chain is kernel B's: the same entries in the same order
// through the same ADD_Z2_1, the same fix-up, so the Jacobian planes are
// bit-identical to kernel B non-strict and to kernels/comb.comb_plain.
//
// Constant time, memory accesses included: no address depends on the
// scalar. Every position is staged whole and every thread reads every
// entry of it with masks (comb_scan.cuh); which buffer and which position
// a step reads is set by the loop counter.
//
// What bounds it: as kernel B, the chain's 32-bit multiply-adds (31 + 1
// mixed adds of 7 M + 4 S), here beside the masked scan (~68 K
// shared-memory words per lane, where kernel B selects on the tensor
// cores); the pipeline holds one more entry (16 words) in registers than
// the serial chain.

#include "coz_p256.cuh"
#include "coz_secp256k1.cuh"
#include "coz_w25519.cuh"
#include "comb_scan.cuh"

namespace p256 {
#include "comb_lane.cuh"
#include "comb_pipe_lane.cuh"
}  // namespace p256

namespace secp256k1 {
#include "comb_lane.cuh"
#include "comb_pipe_lane.cuh"
}  // namespace secp256k1

namespace w25519 {
#include "comb_lane.cuh"
#include "comb_pipe_lane.cuh"
}  // namespace w25519

namespace {

using comb::kThreads;

// Lanes past the end of the batch run the chain on the last lane and store
// nothing: every thread takes part in the block's staging and barriers.
#define EC_COMB_PIPE_KERNEL(NAME, NS)                                                      \
  __global__ void __launch_bounds__(kThreads)                                              \
  NAME(const int32_t* __restrict__ scalars, const uint4* __restrict__ tables,              \
       const int32_t* __restrict__ negbase, int32_t* __restrict__ ax,                      \
       int32_t* __restrict__ ay, int32_t* __restrict__ z, int64_t B) {                     \
    __shared__ uint4 buf[2][comb::kBufVecs];                                               \
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;                      \
    NS::comb_pipe_lane(scalars, tables, negbase, ax, ay, z, B, i < B ? i : B - 1, i < B,   \
                       buf);                                                               \
  }

EC_COMB_PIPE_KERNEL(comb_pipe_p256_kernel, p256)
EC_COMB_PIPE_KERNEL(comb_pipe_secp256k1_kernel, secp256k1)
EC_COMB_PIPE_KERNEL(comb_pipe_w25519_kernel, w25519)

template <class Kernel>
int launch(Kernel kernel, const int32_t* scalars, const int32_t* tables, const int32_t* negbase,
           int32_t* ax, int32_t* ay, int32_t* z, int64_t B, void* stream) {
  if (B > 0) {
    const int64_t blocks = (B + kThreads - 1) / kThreads;
    kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        scalars, reinterpret_cast<const uint4*>(tables), negbase, ax, ay, z, B);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// scalars: (16, B) int32 digit planes; tables: (4224, 16) int32 limbs,
// 16-byte aligned; negbase: 32 int32 digits (x then y) of -B, internal form;
// ax, ay, z: (16, B) outputs. Launches on `stream` and returns
// cudaGetLastError().
extern "C" int ec_comb_pipe_p256(const int32_t* scalars, const int32_t* tables,
                                 const int32_t* negbase, int32_t* ax, int32_t* ay, int32_t* z,
                                 int64_t B, void* stream) {
  return launch(comb_pipe_p256_kernel, scalars, tables, negbase, ax, ay, z, B, stream);
}

extern "C" int ec_comb_pipe_secp256k1(const int32_t* scalars, const int32_t* tables,
                                      const int32_t* negbase, int32_t* ax, int32_t* ay,
                                      int32_t* z, int64_t B, void* stream) {
  return launch(comb_pipe_secp256k1_kernel, scalars, tables, negbase, ax, ay, z, B, stream);
}

extern "C" int ec_comb_pipe_w25519(const int32_t* scalars, const int32_t* tables,
                                   const int32_t* negbase, int32_t* ax, int32_t* ay, int32_t* z,
                                   int64_t B, void* stream) {
  return launch(comb_pipe_w25519_kernel, scalars, tables, negbase, ax, ay, z, B, stream);
}
