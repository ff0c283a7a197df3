// Kernel K: the fixed-base comb's serial chain, software-pipelined, on
// P-256, secp256k1 and Wei25519, one lane per thread (NVIDIA Hopper,
// sm_90a); the lane is comb_pipe_lane.cuh's, written once over the field's
// namespace.
//
// Replaces ecsimd_tpu/kernels/comb.py:_comb_kernel_pipe (chain="pipe"). The
// TPU kernel gathers entry j + 1 on its matrix unit (a one-hot product)
// while its vector unit adds entry j. So does this one: the gather is
// kernel B's one-hot product on the tensor cores (comb_mma::select over a
// position staged in shared memory in comb.mma_layout: ldmatrix, IMMA and
// the warp's row buffer), and the add is the field arithmetic (the
// multiply-add and integer pipes). Iteration j selects entry j + 1 out of
// its staged position into registers and adds entry j, selected in the
// iteration before: the two have no data dependence, so the scheduler can
// issue the selection's IMMA and shared-memory loads beside the add's
// IMADs. Position j + 2 is copied into shared memory meanwhile (cp.async,
// the swizzled comb_mma::stage_copy, double buffered as in kernel B: entry
// j + 1 waits in registers, so no third buffer is needed). The chain is
// kernel B's: the same entries in the same order through the same
// ADD_Z2_1, the same fix-up, so the Jacobian planes are bit-identical to
// kernel B non-strict and to kernels/comb.comb_plain.
//
// Constant time, memory accesses included: no address and no branch
// depends on the scalar. Every position is staged whole, and each warp
// selects its lanes' entries with u8 one-hot products (comb_mma.cuh, which
// says how); which buffer and which position a step reads is set by the
// loop counter.
//
// What bounds it: as kernel B, the chain's 32-bit multiply-adds (31 + 1
// mixed adds of 7 M + 4 S); the selection adds what it adds to kernel B
// (comb.cu: about 290 instructions a lane and a position, 64 of them
// IMMA), and the pipeline holds one more entry (16 words) in registers
// than the serial chain. Shared memory is kernel B's (26 KiB: position 0's
// buffer, the odd positions', the row buffers).

#include "coz_p256.cuh"
#include "coz_secp256k1.cuh"
#include "coz_w25519.cuh"
#include "comb_mma.cuh"

namespace p256 {
#include "comb_lane.cuh"
#include "comb_mma_lane.cuh"
#include "comb_pipe_lane.cuh"
}  // namespace p256

namespace secp256k1 {
#include "comb_lane.cuh"
#include "comb_mma_lane.cuh"
#include "comb_pipe_lane.cuh"
}  // namespace secp256k1

namespace w25519 {
#include "comb_lane.cuh"
#include "comb_mma_lane.cuh"
#include "comb_pipe_lane.cuh"
}  // namespace w25519

namespace {
EC_COMB_PIPE_KERNEL(comb_pipe_p256_kernel, p256)
EC_COMB_PIPE_KERNEL(comb_pipe_secp256k1_kernel, secp256k1)
EC_COMB_PIPE_KERNEL(comb_pipe_w25519_kernel, w25519)
}  // namespace

// scalars: (16, B) int32 digit planes; tables: 4224 x 64 bytes
// (kernels/comb.mma_layout), 16-byte aligned; negbase: 32 int32 digits (x
// then y) of -B, internal form; ax, ay, z: (16, B) outputs. Launches on
// `stream` and returns cudaGetLastError(); <entry>_smem returns the dynamic
// shared memory a block is given (smem_granted), <entry>_blocks the blocks
// an SM holds (blocks_granted).
extern "C" int ec_comb_pipe_p256(const int32_t* scalars, const uint8_t* tables,
                                 const int32_t* negbase, int32_t* ax, int32_t* ay, int32_t* z,
                                 int64_t B, void* stream) {
  return launch_serial<8>(comb_pipe_p256_kernel, scalars, tables, negbase, ax, ay, z, B,
                          stream);
}

extern "C" int ec_comb_pipe_secp256k1(const int32_t* scalars, const uint8_t* tables,
                                      const int32_t* negbase, int32_t* ax, int32_t* ay,
                                      int32_t* z, int64_t B, void* stream) {
  return launch_serial<8>(comb_pipe_secp256k1_kernel, scalars, tables, negbase, ax, ay, z, B,
                          stream);
}

extern "C" int ec_comb_pipe_w25519(const int32_t* scalars, const uint8_t* tables,
                                   const int32_t* negbase, int32_t* ax, int32_t* ay, int32_t* z,
                                   int64_t B, void* stream) {
  return launch_serial<8>(comb_pipe_w25519_kernel, scalars, tables, negbase, ax, ay, z, B,
                          stream);
}

extern "C" int ec_comb_pipe_p256_smem(void) { return smem_granted(comb_pipe_p256_kernel); }
extern "C" int ec_comb_pipe_p256_blocks(void) {
  return blocks_granted(comb_pipe_p256_kernel, comb::kThreads);
}
extern "C" int ec_comb_pipe_secp256k1_smem(void) {
  return smem_granted(comb_pipe_secp256k1_kernel);
}
extern "C" int ec_comb_pipe_secp256k1_blocks(void) {
  return blocks_granted(comb_pipe_secp256k1_kernel, comb::kThreads);
}
extern "C" int ec_comb_pipe_w25519_smem(void) { return smem_granted(comb_pipe_w25519_kernel); }
extern "C" int ec_comb_pipe_w25519_blocks(void) {
  return blocks_granted(comb_pipe_w25519_kernel, comb::kThreads);
}
