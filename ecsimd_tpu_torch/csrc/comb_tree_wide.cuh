// Kernel J on P-384 and P-521 (sm_90a): the field-independent staging of a
// step's pair of positions, the kernel template (EC_COMB_TREE_WIDE_KERNEL)
// and its launcher, for comb_tree_p384.cu and comb_tree_p521.cu. The lane
// is comb_tree_wide_lane.cuh's, included inside the field's namespace.
//
// Replaces ecsimd_tpu/kernels/comb.py:_comb_kernel_tree (chain="tree") and
// its _tree_core, as comb_tree.cu does at 256 bits, which says what the
// tree computes. The 256-bit kernel walks its 16 level-1 pairs in 4-bit
// reversal order and combines while the low bits of the step are set; that
// holds for a power of two only. P-384 has 24 level-1 pairs and P-521 33,
// and a level of n nodes adds node i to node i + n / 2 and passes an odd
// last node on, so here the walk is a table: kernels/comb.tree_schedule(npos),
// checked in as comb_tree_schedule.cuh, gives each step its level-1 pair
// and how many pending sums to fold into the new node (the pending sum
// first: it is the lower-index node). P-384 walks pairs 0, 12, 6, 18, 3, ...
// with at most 4 sums pending; P-521 0, 16, 8, 24, ..., 31 as at 256 bits,
// then pair 32 last (the odd node of every level, added at the root), with
// at most 5 pending.
//
// Shared memory: a step stages its two positions whole (cp.async, double
// buffered) in comb.mma_layout: buffer 0 holds position 0's slot (256
// entries) and one of 128 entries, buffer 1 two of 128, then the per-warp
// row buffers of the selection (comb_mma.cuh) — 62 KiB on P-384 (96-byte
// entries), 87 KiB on P-521 (136-byte entries: the u8 layout has no
// padding words). The pending sums (3 coordinates of 12 or 17 words, 4 or
// 5 of them) would take another 72 KiB or 127.5 KiB in shared memory at 128
// threads a block, more than a P-521 block may have beside the staging;
// 64-thread blocks would fit, at one block (2 warps) an SM. So the pending
// sums live in thread-local memory (an array indexed by the schedule's
// counter, cached in L1 / L2: 576 and 1,020 bytes a thread), and the blocks
// keep kernel B's shape: 128 threads, two blocks an SM on P-521 (its 255
// registers). No index of that array, of the tables or of shared memory
// depends on the scalar: the schedule table and the step counter set them,
// the same in every lane, and each warp selects its lanes' two entries a
// step with u8 one-hot products on the tensor cores (comb_mma::select,
// which says how).
//
// What bounds it: the field multiplies of npos / 2 affine adds (4 M + 2 S),
// npos / 2 - 1 general adds (12 M + 4 S) and the fix-up (7 M + 4 S); the two
// selections a step add what one adds to kernel B (comb.cu, comb_mma.cuh).

#pragma once

#include "comb_mma.cuh"
#include "comb_tree_schedule.cuh"
#include "smem.cuh"

namespace tree_wide {

// The staging slots at N words a coordinate, in bytes: position 0's, any
// other position's, the staging in all and, after it, the row buffers.
template <int N>
struct Slots {
  static constexpr int kLarge = comb_mma::Layout<N>::kBytes0;  // position 0
  static constexpr int kSmall = comb_mma::Layout<N>::kBytes;
  static constexpr int kStage = kLarge + 3 * kSmall;
  static constexpr int kBytes = kStage + comb_mma::kRowBytes;
};

// Slot of a step's lower position (`hi` = 0) or its upper one (`hi` = 1)
// in buffer b.
template <int N>
__device__ __forceinline__ uint8_t* slot(uint8_t* smem, int b, int hi) {
  using S = Slots<N>;
  return smem + (b == 0 ? (hi ? S::kLarge : 0) : S::kLarge + (1 + hi) * S::kSmall);
}

// The calling warp's row buffer, after the staging.
template <int N>
__device__ __forceinline__ uint32_t* rows(uint8_t* smem) {
  return comb_mma::warp_rows(smem + Slots<N>::kStage);
}

// Stage step k's positions p and p + npos / 2 into buffer k & 1, one group.
template <int N, int kNpos>
__device__ __forceinline__ void stage_pair(const uint8_t* tables, int k, uint8_t* smem) {
  const int p = (int)(tree_schedule::Schedule<kNpos>::step(k) & 0xFFu);
  comb_mma::stage_copy<N>(tables, p, slot<N>(smem, k & 1, 0));
  comb_mma::stage_copy<N>(tables, p + kNpos / 2, slot<N>(smem, k & 1, 1));
  comb::commit_staged();
}

}  // namespace tree_wide

namespace {

using comb::kThreads;

// Lanes past the end of the batch run the tree on the last lane and store
// nothing: every thread takes part in the block's staging, barriers and
// products.
#define EC_COMB_TREE_WIDE_KERNEL(NAME, NS)                                                 \
  __global__ void __launch_bounds__(kThreads)                                              \
  NAME(const int32_t* __restrict__ scalars, const uint8_t* __restrict__ tables,            \
       const int32_t* __restrict__ negbase, int32_t* __restrict__ ax,                      \
       int32_t* __restrict__ ay, int32_t* __restrict__ z, int64_t B) {                     \
    extern __shared__ uint4 smem[];                                                        \
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;                      \
    NS::comb_tree_wide_lane(scalars, tables, negbase, ax, ay, z, B, i < B ? i : B - 1,     \
                            i < B, reinterpret_cast<uint8_t*>(smem));                      \
  }

// Launch `kernel` (N words a coordinate) on `stream` with its staging and
// row buffers as dynamic shared memory; return cudaGetLastError() (or the
// attribute's error).
template <int N, class Kernel>
int launch_tree_wide(Kernel kernel, const int32_t* scalars, const uint8_t* tables,
                     const int32_t* negbase, int32_t* ax, int32_t* ay, int32_t* z, int64_t B,
                     void* stream) {
  if (B > 0) {
    constexpr int bytes = tree_wide::Slots<N>::kBytes;
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    const int64_t blocks = (B + kThreads - 1) / kThreads;
    kernel<<<(unsigned)blocks, kThreads, bytes, (cudaStream_t)stream>>>(
        scalars, tables, negbase, ax, ay, z, B);
  }
  return (int)cudaGetLastError();
}

}  // namespace
