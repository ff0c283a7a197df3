// Kernel J: the fixed-base comb summed by a pairwise tree on P-256,
// secp256k1 and Wei25519, one lane per thread (NVIDIA Hopper, sm_90a); the
// lane is comb_tree_lane.cuh's, written once over the field's namespace.
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
// masked scan (~68 K shared-memory words per lane); the 88 KiB
// of shared memory allow two blocks of 128 threads per SM.

#include "coz_p256.cuh"
#include "coz_secp256k1.cuh"
#include "coz_w25519.cuh"
#include "comb_scan.cuh"
#include "smem.cuh"

namespace tree {

constexpr int kPairs = comb::kPositions / 2;      // level-1 pairs (i, i + 16)
constexpr int kLevels = 4;                         // log2(kPairs): pending sums
constexpr int kPointWords = 24;                    // x, y, z limbs
constexpr int kSlotVecs = comb::kHalfEntries * comb::kEntryVecs;  // 8 KiB
constexpr int kStageVecs = comb::kBufVecs + 3 * kSlotVecs;       // 40 KiB
constexpr int kStackWords = kLevels * kPointWords * comb::kThreads;  // 48 KiB

// Slot of position i (`hi` = 0) or i + 16 (`hi` = 1) in buffer b.
__device__ __forceinline__ uint4* slot(uint4* smem, int b, int hi) {
  return smem + (b == 0 ? (hi ? comb::kBufVecs : 0)
                        : comb::kBufVecs + (1 + hi) * kSlotVecs);
}

__device__ __forceinline__ int leaf(int k) { return (int)(__brev((unsigned)k) >> 28); }

__device__ __forceinline__ void stage_pair(const uint4* tables, int k, uint4* smem) {
  const int i = leaf(k);
  comb::stage_copy(tables, i, slot(smem, k & 1, 0));
  comb::stage_copy(tables, i + kPairs, slot(smem, k & 1, 1));
  comb::commit_staged();
}

__device__ __forceinline__ void stack_put(uint32_t* stack, int level, const ec::fe& x,
                                          const ec::fe& y, const ec::fe& z) {
  uint32_t* s = stack + level * kPointWords * comb::kThreads + threadIdx.x;
#pragma unroll
  for (int w = 0; w < 8; ++w) {
    s[w * comb::kThreads] = x.v[w];
    s[(8 + w) * comb::kThreads] = y.v[w];
    s[(16 + w) * comb::kThreads] = z.v[w];
  }
}

__device__ __forceinline__ void stack_get(const uint32_t* stack, int level, ec::fe& x,
                                          ec::fe& y, ec::fe& z) {
  const uint32_t* s = stack + level * kPointWords * comb::kThreads + threadIdx.x;
#pragma unroll
  for (int w = 0; w < 8; ++w) {
    x.v[w] = s[w * comb::kThreads];
    y.v[w] = s[(8 + w) * comb::kThreads];
    z.v[w] = s[(16 + w) * comb::kThreads];
  }
}

}  // namespace tree

namespace p256 {
#include "comb_lane.cuh"
#include "comb_tree_lane.cuh"
}  // namespace p256

namespace secp256k1 {
#include "comb_lane.cuh"
#include "comb_tree_lane.cuh"
}  // namespace secp256k1

namespace w25519 {
#include "comb_lane.cuh"
#include "comb_tree_lane.cuh"
}  // namespace w25519

namespace {

using comb::kThreads;
constexpr int kSmemBytes = (tree::kStageVecs * (int)sizeof(uint4)) + tree::kStackWords * 4;

// Lanes past the end of the batch run the tree on the last lane and store
// nothing: every thread takes part in the block's staging and barriers.
#define EC_COMB_TREE_KERNEL(NAME, NS)                                                      \
  __global__ void __launch_bounds__(kThreads)                                              \
  NAME(const int32_t* __restrict__ scalars, const uint4* __restrict__ tables,              \
       const int32_t* __restrict__ negbase, int32_t* __restrict__ ax,                      \
       int32_t* __restrict__ ay, int32_t* __restrict__ z, int64_t B) {                     \
    extern __shared__ uint4 smem[];                                                        \
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;                      \
    NS::comb_tree_lane(scalars, tables, negbase, ax, ay, z, B, i < B ? i : B - 1, i < B,   \
                       smem);                                                              \
  }

EC_COMB_TREE_KERNEL(comb_tree_p256_kernel, p256)
EC_COMB_TREE_KERNEL(comb_tree_secp256k1_kernel, secp256k1)
EC_COMB_TREE_KERNEL(comb_tree_w25519_kernel, w25519)

template <class Kernel>
int launch(Kernel kernel, const int32_t* scalars, const int32_t* tables, const int32_t* negbase,
           int32_t* ax, int32_t* ay, int32_t* z, int64_t B, void* stream) {
  if (B > 0) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    const int64_t blocks = (B + kThreads - 1) / kThreads;
    kernel<<<(unsigned)blocks, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
        scalars, reinterpret_cast<const uint4*>(tables), negbase, ax, ay, z, B);
  }
  return (int)cudaGetLastError();
}


}  // namespace

// scalars: (16, B) int32 digit planes; tables: (4224, 16) int32 limbs,
// 16-byte aligned; negbase: 32 int32 digits (x then y) of -B, internal form;
// ax, ay, z: (16, B) outputs. Launches on `stream` and returns
// cudaGetLastError(). <entry>_smem returns the dynamic shared memory of its
// block (smem_granted).
extern "C" int ec_comb_tree_p256(const int32_t* scalars, const int32_t* tables,
                                 const int32_t* negbase, int32_t* ax, int32_t* ay, int32_t* z,
                                 int64_t B, void* stream) {
  return launch(comb_tree_p256_kernel, scalars, tables, negbase, ax, ay, z, B, stream);
}

extern "C" int ec_comb_tree_secp256k1(const int32_t* scalars, const int32_t* tables,
                                      const int32_t* negbase, int32_t* ax, int32_t* ay,
                                      int32_t* z, int64_t B, void* stream) {
  return launch(comb_tree_secp256k1_kernel, scalars, tables, negbase, ax, ay, z, B, stream);
}

extern "C" int ec_comb_tree_w25519(const int32_t* scalars, const int32_t* tables,
                                   const int32_t* negbase, int32_t* ax, int32_t* ay, int32_t* z,
                                   int64_t B, void* stream) {
  return launch(comb_tree_w25519_kernel, scalars, tables, negbase, ax, ay, z, B, stream);
}

extern "C" int ec_comb_tree_p256_smem(void) { return smem_granted(comb_tree_p256_kernel); }
extern "C" int ec_comb_tree_secp256k1_smem(void) {
  return smem_granted(comb_tree_secp256k1_kernel);
}
extern "C" int ec_comb_tree_w25519_smem(void) { return smem_granted(comb_tree_w25519_kernel); }
