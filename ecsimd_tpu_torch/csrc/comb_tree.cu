// Kernel J: the fixed-base comb summed by a pairwise tree on P-256, one
// lane per thread (NVIDIA Hopper, sm_90a).
//
// Replaces ecsimd_tpu/kernels/comb.py:_comb_kernel_tree (chain="tree") and
// its _tree_core. The TPU kernel gathers all 32 entries of a lane, then adds
// them level by level batched over a point axis: level 1 adds entry i to
// entry i + 16 (affine + affine, aff_add), each further level adds node i
// to node i + n/2 of the n nodes left (the general Jacobian add), then the
// parity fix-up adds -B on even scalars. Holding 32 gathered entries per
// lane would take 2 KiB of state a thread; this kernel streams the tree
// instead. Step k (0..15) visits the level-1 pair (i, i + 16) with i the
// 4-bit reversal of k (0, 8, 4, 12, 2, ...), and a stack of at most four
// pending partial sums, one per level, combines the new node with the
// pending ones while the low bits of k are set. That visits exactly the
// pairs of the batched tree, and each add keeps its operand order (the
// lower-index node first; a swapped add gives another Jacobian
// representative of the same point), so the Jacobian planes are
// bit-identical to kernels/comb.comb_tree_plain.
//
// Constant time, memory accesses included: no address depends on the
// scalar. The two positions of step k are staged whole in shared memory
// (cp.async, double buffered) and every thread reads every entry of them
// with masks (comb_scan.cuh); which positions, slots and stack levels a
// step touches is set by the loop counter alone, the same in every lane.
//
// Shared memory (dynamic, 88 KiB): the staging buffers (buffer 0: position
// 0 or i, 16 KiB, and position i + 16, 8 KiB; buffer 1: two slots of
// 8 KiB) and the stack, 4 levels x 24 words (x, y, z) per thread, word w of
// level l of thread t at (l * 24 + w) * 128 + t so that a warp's accesses
// fall in distinct banks. The stack lives there, not in registers, so the
// chain's registers stay those of one add.
//
// What bounds it: the 32-bit multiply-adds of 16 affine adds (4 M + 2 S),
// 15 general adds (12 M + 4 S) and the fix-up (7 M + 4 S), beside the
// masked scan (~68 K shared-memory words per lane, as kernel B); the 88 KiB
// of shared memory allow two blocks of 128 threads per SM.

#include "coz_p256.cuh"
#include "comb_scan.cuh"

namespace p256 {
#include "comb_lane.cuh"

constexpr int kPairs = comb::kPositions / 2;      // level-1 pairs (i, i + 16)
constexpr int kLevels = 4;                         // log2(kPairs): pending sums
constexpr int kPointWords = 24;                    // x, y, z limbs
constexpr int kSlotVecs = comb::kHalfEntries * comb::kEntryVecs;  // 8 KiB
constexpr int kStageVecs = comb::kBufVecs + 3 * kSlotVecs;       // 40 KiB
constexpr int kStackWords = kLevels * kPointWords * comb::kThreads;  // 48 KiB

// Slot of position i (`hi` = 0) or i + 16 (`hi` = 1) in buffer b.
__device__ __forceinline__ uint4* tree_slot(uint4* smem, int b, int hi) {
  return smem + (b == 0 ? (hi ? comb::kBufVecs : 0) : comb::kBufVecs + (1 + hi) * kSlotVecs);
}

__device__ __forceinline__ int tree_leaf(int k) { return (int)(__brev((unsigned)k) >> 28); }

__device__ __forceinline__ void stage_pair(const uint4* tables, int k, uint4* smem) {
  const int i = tree_leaf(k);
  comb::stage_copy(tables, i, tree_slot(smem, k & 1, 0));
  comb::stage_copy(tables, i + kPairs, tree_slot(smem, k & 1, 1));
  comb::commit_staged();
}

__device__ __forceinline__ void stack_put(uint32_t* stack, int level, const fe& x, const fe& y,
                                          const fe& z) {
  uint32_t* s = stack + level * kPointWords * comb::kThreads + threadIdx.x;
#pragma unroll
  for (int w = 0; w < 8; ++w) {
    s[w * comb::kThreads] = x.v[w];
    s[(8 + w) * comb::kThreads] = y.v[w];
    s[(16 + w) * comb::kThreads] = z.v[w];
  }
}

__device__ __forceinline__ void stack_get(const uint32_t* stack, int level, fe& x, fe& y,
                                          fe& z) {
  const uint32_t* s = stack + level * kPointWords * comb::kThreads + threadIdx.x;
#pragma unroll
  for (int w = 0; w < 8; ++w) {
    x.v[w] = s[w * comb::kThreads];
    y.v[w] = s[(8 + w) * comb::kThreads];
    z.v[w] = s[(16 + w) * comb::kThreads];
  }
}

// One lane of the tree; every thread takes part in the block's staging and
// barriers, and only active lanes store.
__device__ __forceinline__ void comb_tree_lane(const int32_t* scalars, const uint4* tables,
                                               const int32_t* negbase, int32_t* ax_out,
                                               int32_t* ay_out, int32_t* z_out, int64_t B,
                                               int64_t i, bool active, uint4* smem) {
  uint32_t* stack = reinterpret_cast<uint32_t*>(smem + kStageVecs);
  fe x, y, z;
  stage_pair(tables, 0, smem);
#pragma unroll 1
  for (int k = 0; k < kPairs; ++k) {
    if (k + 1 < kPairs) {
      stage_pair(tables, k + 1, smem);
      comb::wait_staged<1>();
    } else {
      comb::wait_staged<0>();
    }
    __syncthreads();
    const int lo = tree_leaf(k);
    fe ax, ay, bx, by;
    read_entry(tree_slot(smem, k & 1, 0), lo, comb::entry_index(scalars, B, i, lo), ax, ay);
    read_signed_entry(tree_slot(smem, k & 1, 1), comb::entry_index(scalars, B, i, lo + kPairs),
                      bx, by);
    __syncthreads();  // the next step stages into the buffer just read
    aff_add(ax, ay, bx, by, x, y, z);  // node lo of level 1
    // add the pending node of each level whose bit of k is set (it has the
    // lower index), and leave the new node pending at the first clear bit
#pragma unroll 1
    for (int l = 0; l < kLevels; ++l) {
      if (((k >> l) & 1) == 0) {
        stack_put(stack, l, x, y, z);
        break;
      }
      fe px, py, pz, h, r;
      stack_get(stack, l, px, py, pz);
      jac_add(px, py, pz, x, y, z, x, y, z, h, r);
    }
  }
  // k = 15 set every bit: (x, y, z) is the root
  comb_finish<false>(x, y, z, scalars, negbase, ax_out, ay_out, z_out, B, i, active);
}

}  // namespace p256

namespace {

using comb::kThreads;
constexpr int kSmemBytes = (p256::kStageVecs * (int)sizeof(uint4)) + p256::kStackWords * 4;

// Lanes past the end of the batch run the tree on the last lane and store
// nothing: every thread takes part in the block's staging and barriers.
__global__ void __launch_bounds__(kThreads)
comb_tree_p256_kernel(const int32_t* __restrict__ scalars, const uint4* __restrict__ tables,
                      const int32_t* __restrict__ negbase, int32_t* __restrict__ ax,
                      int32_t* __restrict__ ay, int32_t* __restrict__ z, int64_t B) {
  extern __shared__ uint4 smem[];
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  p256::comb_tree_lane(scalars, tables, negbase, ax, ay, z, B, i < B ? i : B - 1, i < B, smem);
}

}  // namespace

// scalars: (16, B) int32 digit planes; tables: (4224, 16) int32 limbs,
// 16-byte aligned; negbase: 32 int32 digits (x then y) of -B; ax, ay, z:
// (16, B) outputs. Launches on `stream` and returns cudaGetLastError().
extern "C" int ec_comb_tree_p256(const int32_t* scalars, const int32_t* tables,
                                 const int32_t* negbase, int32_t* ax, int32_t* ay, int32_t* z,
                                 int64_t B, void* stream) {
  if (B > 0) {
    const cudaError_t err = cudaFuncSetAttribute(
        comb_tree_p256_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    const int64_t blocks = (B + kThreads - 1) / kThreads;
    comb_tree_p256_kernel<<<(unsigned)blocks, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
        scalars, reinterpret_cast<const uint4*>(tables), negbase, ax, ay, z, B);
  }
  return (int)cudaGetLastError();
}

// The dynamic shared memory the runtime gives a block of kernel J, as
// ec_comb_tree_p256 set it (cudaFuncAttributes::maxDynamicSharedSizeBytes),
// or minus the CUDA error if the query fails.
extern "C" int ec_comb_tree_p256_smem(void) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, comb_tree_p256_kernel);
  return err == cudaSuccess ? attr.maxDynamicSharedSizeBytes : -(int)err;
}
