// Kernel L, generic: the fixed-base comb's serial chain split into `chains`
// independent chains, at any schedule the JAX package accepts (npos a
// multiple of chains * unroll), one kernel a curve and mode whose chains and
// unroll are run-time ints, one lane per thread (NVIDIA Hopper, sm_90a).
//
// Replaces ecsimd_tpu/kernels/comb.py:_comb_kernel with chains > 1 and/or
// unroll > 1 (the grid of comb_mont_planes and its position permutation),
// every such schedule on every curve.
//
// Chain c covers the contiguous positions c P .. (c + 1) P - 1, P = npos /
// chains, and the chains are combined left to right, so one walk over the
// positions 0 .. npos - 1 in kernel B's order gives the value of
// kernels/comb.comb_chains_plain bit for bit. At a position j with j % P == 0
// and j > 0 the walk folds the running chain into a running total
// (jac_add(total, chain); at j == P the chain is the total) and reseeds the
// chain from the entry with z = 1; every other position is an ADD_Z2_1 (the
// complete add when strict, which allows one chain only); at the end the
// last chain is folded in the same way, then the parity fix-up. Whatever
// `chains` is, the lane holds two Jacobian points, so chains = npos costs
// no more registers than chains = 2. With one chain this is kernel B's chain, bit for bit.
//
// `unroll` changes no value. It sets how many positions a step stages in
// shared memory as one group (cp.async, double buffered; one pair of
// barriers a group): g = unroll, at most 4 at 256 bits (74 KiB with the
// row buffers, three blocks an SM) and 2 on
// P-384 and P-521 (62 and 87 KiB: the first slot holds position 0, 256
// entries; two blocks an SM at their registers), lowered to a divisor of
// npos (kernels/comb.general_group computes the same on the host).
//
// Constant time, memory accesses included: no address and no branch
// depends on the scalar. Every position is staged whole in the layout of
// kernel B (kernels/comb.mma_layout), and each warp selects its lanes'
// entries with u8 one-hot products on the tensor cores (comb_mma.cuh, which
// says how); which slot, which position and whether a position reseeds a
// chain are set by the loop counters and the launch's ints, the same in
// every lane.
//
// What bounds it: the field multiplies of npos - chains mixed adds, chains -
// 1 general adds (12 M + 4 S) and the fix-up; the selection adds, a lane
// and a position, what it adds to kernel B (comb.cu).
//
// This header holds the field-independent staging, the kernel template
// (EC_COMB_GENERAL_KERNEL, two a namespace) and the launcher; the lane is
// comb_general_lane.cuh's, included inside the field's namespace after
// comb_lane.cuh and comb_mma_lane.cuh. One source a curve (comb_general.cu
// on P-256, comb_general_<tag>.cu), so that the builds run side by side.

#pragma once

#include "comb_mma.cuh"

namespace general {

// The most positions a step stages at N words a coordinate.
template <int N>
constexpr int group_cap() {
  return N <= 8 ? 4 : 2;
}

// The bytes of the generic kernel L's shared memory at N words a coordinate
// and g positions a step: buffer 0 (position 0's slot and g - 1 slots of
// another position), buffer 1 (g slots), the row buffers.
template <int N>
constexpr int smem_bytes(int g) {
  using L = comb_mma::Layout<N>;
  return L::kBytes0 + (2 * g - 1) * L::kBytes + comb_mma::kRowBytes;
}

// Slot q of buffer b, g positions a step: buffer 0 is position 0's slot
// and g - 1 slots of another position, buffer 1 g slots.
template <int N>
__device__ __forceinline__ uint8_t* slot(uint8_t* smem, int b, int q, int g) {
  using L = comb_mma::Layout<N>;
  if (b == 0) return smem + (q == 0 ? 0 : L::kBytes0 + (q - 1) * L::kBytes);
  return smem + L::kBytes0 + (g - 1 + q) * L::kBytes;
}

// The calling warp's row buffer, after the slots of g positions a step.
template <int N>
__device__ __forceinline__ uint32_t* rows(uint8_t* smem, int g) {
  using L = comb_mma::Layout<N>;
  return comb_mma::warp_rows(smem + L::kBytes0 + (2 * g - 1) * L::kBytes);
}

// Stage positions s g .. s g + g - 1 into buffer s & 1, as one group.
template <int N>
__device__ __forceinline__ void stage_step(const uint8_t* tables, int s, int g, uint8_t* smem) {
#pragma unroll 1
  for (int q = 0; q < g; ++q) {
    comb_mma::stage_copy<N>(tables, s * g + q, slot<N>(smem, s & 1, q, g));
  }
  comb::commit_staged();
}

}  // namespace general

namespace {

using comb::kThreads;

// Lanes past the end of the batch run the walk on the last lane and store
// nothing: every thread takes part in the block's staging and barriers.
#define EC_COMB_GENERAL_KERNEL(NAME, NS, STRICT, MIN_BLOCKS)                                \
  __global__ void __launch_bounds__(kThreads, MIN_BLOCKS)                                  \
  NAME(const int32_t* __restrict__ scalars, const uint8_t* __restrict__ tables,           \
       const int32_t* __restrict__ negbase, int32_t* __restrict__ ax,                      \
       int32_t* __restrict__ ay, int32_t* __restrict__ z, int64_t B, int per, int group) { \
    extern __shared__ uint4 smem[];                                                        \
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;                      \
    NS::comb_general_lane<STRICT>(scalars, tables, negbase, ax, ay, z, B,                  \
                                  i < B ? i : B - 1, i < B,                                \
                                  reinterpret_cast<uint8_t*>(smem), per, group);           \
  }

// Launch `kernel` (N words a coordinate, npos positions) at `chains` and
// `unroll` on `stream`; return cudaGetLastError(), or cudaErrorInvalidValue
// for a schedule the JAX package rejects (npos not a multiple of chains *
// unroll, strict with more than one chain).
template <int N, int kNpos, class Kernel>
int launch_general(Kernel kernel, bool strict, const int32_t* scalars, const uint8_t* tables,
                   const int32_t* negbase, int32_t* ax, int32_t* ay, int32_t* z, int64_t B,
                   int64_t chains, int64_t unroll, void* stream) {
  if (chains < 1 || unroll < 1 || kNpos % (chains * unroll) != 0 || (strict && chains != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  int group = unroll < general::group_cap<N>() ? (int)unroll : general::group_cap<N>();
  while (kNpos % group != 0) --group;
  if (B > 0) {
    const int bytes = general::smem_bytes<N>(group);
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    const int64_t blocks = (B + kThreads - 1) / kThreads;
    kernel<<<(unsigned)blocks, kThreads, bytes, (cudaStream_t)stream>>>(
        scalars, tables, negbase, ax, ay, z, B,
        (int)(kNpos / chains), group);
  }
  return (int)cudaGetLastError();
}

}  // namespace
