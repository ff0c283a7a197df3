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
// Constant time, memory accesses included: no address and no branch
// depends on the scalar. The two positions of step k are staged whole in
// shared memory (cp.async, double buffered) in comb.mma_layout, and each
// warp selects its lanes' two entries with u8 one-hot products on the
// tensor cores (comb_mma::select, twice a step, through the warp's row
// buffer; comb_mma.cuh says how); which positions, slots and stack levels
// a step touches is set by the loop counter alone, the same in every lane.
//
// Shared memory (dynamic, 42 KiB): the staging buffers (buffer 0: position
// 0 or i, 16 KiB, and position i + 16, 8 KiB; buffer 1: two slots of
// 8 KiB) and the row buffers (2 KiB). The stack of pending sums, 4 levels x
// 24 words (x, y, z) a thread, lives in thread-local memory (an array
// indexed by the level, a loop counter; 384 bytes a thread, cached in L1 /
// L2), as in the wide kernel J (comb_tree_wide.cuh). The same stack in
// shared memory (another 48 KiB: two blocks an SM, where the registers
// allow three or four) was 0.3 %, 8 % and 3 % slower on P-256, secp256k1
// and Wei25519 (PERF.md).
//
// What bounds it: the 32-bit multiply-adds of 16 affine adds (4 M + 2 S),
// 15 general adds (12 M + 4 S) and the fix-up (7 M + 4 S); the two
// selections a step add what one adds to kernel B (comb.cu: about 290
// instructions a lane and a position, 64 of them IMMA, 128 at position 0).

#include "coz_p256.cuh"
#include "coz_secp256k1.cuh"
#include "coz_w25519.cuh"
#include "comb_mma.cuh"
#include "smem.cuh"

namespace tree {

using L = comb_mma::Layout<8>;
constexpr int kPairs = comb::kPositions / 2;      // level-1 pairs (i, i + 16)
constexpr int kLevels = 4;                         // log2(kPairs): pending sums
constexpr int kStageBytes = L::kBytes0 + 3 * L::kBytes;          // 40 KiB
constexpr int kSmemBytes = kStageBytes + comb_mma::kRowBytes;

// Slot of position i (`hi` = 0) or i + 16 (`hi` = 1) in buffer b.
__device__ __forceinline__ uint8_t* slot(uint8_t* smem, int b, int hi) {
  return smem + (b == 0 ? (hi ? L::kBytes0 : 0) : L::kBytes0 + (1 + hi) * L::kBytes);
}

// The calling warp's row buffer, after the staging.
__device__ __forceinline__ uint32_t* rows(uint8_t* smem) {
  return comb_mma::warp_rows(smem + kStageBytes);
}

__device__ __forceinline__ int leaf(int k) { return (int)(__brev((unsigned)k) >> 28); }

__device__ __forceinline__ void stage_pair(const uint8_t* tables, int k, uint8_t* smem) {
  const int i = leaf(k);
  comb_mma::stage_copy<8>(tables, i, slot(smem, k & 1, 0));
  comb_mma::stage_copy<8>(tables, i + kPairs, slot(smem, k & 1, 1));
  comb::commit_staged();
}

}  // namespace tree

namespace p256 {
#include "comb_lane.cuh"
#include "comb_mma_lane.cuh"
#include "comb_tree_lane.cuh"
}  // namespace p256

namespace secp256k1 {
#include "comb_lane.cuh"
#include "comb_mma_lane.cuh"
#include "comb_tree_lane.cuh"
}  // namespace secp256k1

namespace w25519 {
#include "comb_lane.cuh"
#include "comb_mma_lane.cuh"
#include "comb_tree_lane.cuh"
}  // namespace w25519

namespace {

using comb::kThreads;

// Lanes past the end of the batch run the tree on the last lane and store
// nothing: every thread takes part in the block's staging, barriers and
// products.
#define EC_COMB_TREE_KERNEL(NAME, NS)                                                      \
  __global__ void __launch_bounds__(kThreads)                                              \
  NAME(const int32_t* __restrict__ scalars, const uint8_t* __restrict__ tables,            \
       const int32_t* __restrict__ negbase, int32_t* __restrict__ ax,                      \
       int32_t* __restrict__ ay, int32_t* __restrict__ z, int64_t B) {                     \
    extern __shared__ uint4 smem[];                                                        \
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;                      \
    NS::comb_tree_lane(scalars, tables, negbase, ax, ay, z, B, i < B ? i : B - 1, i < B,   \
                       reinterpret_cast<uint8_t*>(smem));                                  \
  }

EC_COMB_TREE_KERNEL(comb_tree_p256_kernel, p256)
EC_COMB_TREE_KERNEL(comb_tree_secp256k1_kernel, secp256k1)
EC_COMB_TREE_KERNEL(comb_tree_w25519_kernel, w25519)

template <class Kernel>
int launch(Kernel kernel, const int32_t* scalars, const uint8_t* tables, const int32_t* negbase,
           int32_t* ax, int32_t* ay, int32_t* z, int64_t B, void* stream) {
  if (B > 0) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, tree::kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    const int64_t blocks = (B + kThreads - 1) / kThreads;
    kernel<<<(unsigned)blocks, kThreads, tree::kSmemBytes, (cudaStream_t)stream>>>(
        scalars, tables, negbase, ax, ay, z, B);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// scalars: (16, B) int32 digit planes; tables: 4224 x 64 bytes
// (kernels/comb.mma_layout), 16-byte aligned; negbase: 32 int32 digits (x
// then y) of -B, internal form; ax, ay, z: (16, B) outputs. Launches on
// `stream` and returns cudaGetLastError(); <entry>_smem returns the dynamic
// shared memory a block is given (smem_granted), <entry>_blocks the blocks
// an SM holds (blocks_granted).
extern "C" int ec_comb_tree_p256(const int32_t* scalars, const uint8_t* tables,
                                 const int32_t* negbase, int32_t* ax, int32_t* ay, int32_t* z,
                                 int64_t B, void* stream) {
  return launch(comb_tree_p256_kernel, scalars, tables, negbase, ax, ay, z, B, stream);
}

extern "C" int ec_comb_tree_secp256k1(const int32_t* scalars, const uint8_t* tables,
                                      const int32_t* negbase, int32_t* ax, int32_t* ay,
                                      int32_t* z, int64_t B, void* stream) {
  return launch(comb_tree_secp256k1_kernel, scalars, tables, negbase, ax, ay, z, B, stream);
}

extern "C" int ec_comb_tree_w25519(const int32_t* scalars, const uint8_t* tables,
                                   const int32_t* negbase, int32_t* ax, int32_t* ay, int32_t* z,
                                   int64_t B, void* stream) {
  return launch(comb_tree_w25519_kernel, scalars, tables, negbase, ax, ay, z, B, stream);
}

extern "C" int ec_comb_tree_p256_smem(void) { return smem_granted(comb_tree_p256_kernel); }
extern "C" int ec_comb_tree_p256_blocks(void) {
  return blocks_granted(comb_tree_p256_kernel, kThreads);
}
extern "C" int ec_comb_tree_secp256k1_smem(void) {
  return smem_granted(comb_tree_secp256k1_kernel);
}
extern "C" int ec_comb_tree_secp256k1_blocks(void) {
  return blocks_granted(comb_tree_secp256k1_kernel, kThreads);
}
extern "C" int ec_comb_tree_w25519_smem(void) { return smem_granted(comb_tree_w25519_kernel); }
extern "C" int ec_comb_tree_w25519_blocks(void) {
  return blocks_granted(comb_tree_w25519_kernel, kThreads);
}
