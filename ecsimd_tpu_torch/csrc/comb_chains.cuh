// Kernel L: the fixed-base comb with `chains` independent serial chains,
// each taking `unroll` positions per staging step, on P-256, secp256k1 and
// Wei25519, one lane per thread (NVIDIA Hopper, sm_90a).
//
// Replaces ecsimd_tpu/kernels/comb.py:_comb_kernel with chains > 1 and/or
// unroll > 1 (the grid of comb_mont_planes and its position permutation).
// Chain c sums positions c * P .. (c + 1) * P - 1, P = 32 / chains, in
// order: it is seeded from its first entry with z = 1 (only chain 0's seed,
// position 0, carries the recoding's top digit) and adds each further
// entry with ADD_Z2_1. Then the chains are combined left to right with the
// general Jacobian add (acc_0 + acc_1, then + acc_2, ...) and the parity
// fix-up adds -B on even scalars: the order of
// kernels/comb.comb_chains_plain, so the Jacobian planes agree bit for bit.
// With one chain this is kernel B's chain (strict too: every add, the
// fix-up included, is add_complete), bit-identical to it.
//
// On the TPU the chains fill the vector unit's pipeline, since one chain's
// step is latency-bound. Here the chains give each thread independent
// instruction streams (ILP); `unroll` sets how many positions a chain takes
// per staging step: g = chains * unroll positions are copied into shared
// memory as one group (cp.async, double buffered), so a step has one pair
// of barriers for g positions instead of one.
//
// Constant time, memory accesses included: no address depends on the
// scalar. Every position is staged whole and every thread reads every
// entry of it with masks (comb_scan.cuh); which slot and which position a
// step reads is set by the loop counters.
//
// Shared memory (dynamic): buffer 0 holds position 0 (256 entries, 16 KiB)
// in its first slot and g - 1 positions of 128 entries (8 KiB) after it;
// buffer 1 holds g positions of 8 KiB. g = 2: 40 KiB; g = 4: 72 KiB.
//
// What bounds it: the 32-bit multiply-adds of 32 - chains mixed adds
// (7 M + 4 S), chains - 1 general adds (12 M + 4 S) and the fix-up, beside
// the masked scan (~68 K shared-memory words per lane); the chains hold
// 24 words of accumulator each in registers.
//
// The instantiations are split over two sources a curve so that their
// builds run side by side: comb_chains.cu (chains 2 and 4) and
// comb_unroll.cu (one chain: unroll 2 and 4, strict too) on P-256, and
// comb_chains_<curve>.cu, comb_unroll_<curve>.cu on secp256k1 and Wei25519.
// This header holds the field-independent staging, the kernel template
// (EC_COMB_CHAINS_KERNEL, one a namespace) and the launcher; the lane is
// comb_chains_lane.cuh's, included inside the field's namespace.

#pragma once

#include "comb_scan.cuh"

namespace chains {

constexpr int kSlotVecs = comb::kHalfEntries * comb::kEntryVecs;  // a position 1..31, 8 KiB
constexpr int kSlot0Vecs = comb::kBufVecs;                        // position 0, 16 KiB

// Slot q of buffer b (see the header).
template <int kG>
__device__ __forceinline__ uint4* slot(uint4* smem, int b, int q) {
  if (b == 0) return smem + (q == 0 ? 0 : kSlot0Vecs + (q - 1) * kSlotVecs);
  return smem + kSlot0Vecs + (kG - 1) * kSlotVecs + q * kSlotVecs;
}

// Position of slot q = c * kUnroll + u at step s.
template <int kChains, int kUnroll>
__device__ __forceinline__ int position(int s, int c, int u) {
  return c * (comb::kPositions / kChains) + s * kUnroll + u;
}

template <int kChains, int kUnroll>
__device__ __forceinline__ void stage_step(const uint4* tables, int s, uint4* smem) {
  constexpr int kG = kChains * kUnroll;
#pragma unroll
  for (int c = 0; c < kChains; ++c) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      comb::stage_copy(tables, position<kChains, kUnroll>(s, c, u),
                       slot<kG>(smem, s & 1, c * kUnroll + u));
    }
  }
  comb::commit_staged();
}

}  // namespace chains

namespace {

using comb::kThreads;
// Three blocks per SM, the most that g = 4's 72 KiB of staging lets in:
// left to itself, ptxas gave the two- and four-chain and the strict
// instantiations 178 to 254 registers a thread, two blocks per SM; asked
// for three, it keeps them within 168.
constexpr int kMinBlocks = 3;

template <int kChains, int kUnroll>
constexpr int smem_bytes() {
  constexpr int vecs = chains::kSlot0Vecs + (2 * kChains * kUnroll - 1) * chains::kSlotVecs;
  return vecs * (int)sizeof(uint4);
}

// Lanes past the end of the batch run the chains on the last lane and store
// nothing: every thread takes part in the block's staging and barriers.
#define EC_COMB_CHAINS_KERNEL(NS)                                                          \
  template <int kChains, int kUnroll, bool kStrict>                                        \
  __global__ void __launch_bounds__(kThreads, kMinBlocks) comb_chains_##NS##_kernel(       \
      const int32_t* __restrict__ scalars, const uint4* __restrict__ tables,               \
      const int32_t* __restrict__ negbase, int32_t* __restrict__ ax,                       \
      int32_t* __restrict__ ay, int32_t* __restrict__ z, int64_t B) {                      \
    extern __shared__ uint4 smem[];                                                        \
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;                      \
    NS::comb_chains_lane<kChains, kUnroll, kStrict>(scalars, tables, negbase, ax, ay, z, B, \
                                                    i < B ? i : B - 1, i < B, smem);      \
  }

// Launch `kernel`, an instantiation of EC_COMB_CHAINS_KERNEL's template at
// kChains and kUnroll, on `stream`; return cudaGetLastError().
template <int kChains, int kUnroll, class Kernel>
int launch(Kernel kernel, const int32_t* scalars, const int32_t* tables, const int32_t* negbase,
           int32_t* ax, int32_t* ay, int32_t* z, int64_t B, void* stream) {
  if (B > 0) {
    constexpr int bytes = smem_bytes<kChains, kUnroll>();
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    const int64_t blocks = (B + kThreads - 1) / kThreads;
    kernel<<<(unsigned)blocks, kThreads, bytes, (cudaStream_t)stream>>>(
        scalars, reinterpret_cast<const uint4*>(tables), negbase, ax, ay, z, B);
  }
  return (int)cudaGetLastError();
}

// The dynamic shared memory the runtime gives a block of `kernel`, as
// `launch` set it (cudaFuncAttributes::maxDynamicSharedSizeBytes), or minus
// the CUDA error if the query fails.
template <class Kernel>
int smem_granted(Kernel kernel) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  return err == cudaSuccess ? attr.maxDynamicSharedSizeBytes : -(int)err;
}

}  // namespace
