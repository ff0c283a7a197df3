// Kernel D: Jacobian -> affine on P-256, secp256k1, Wei25519, P-384 and
// P-521 by a Montgomery batch inversion inside the kernel (NVIDIA Hopper,
// sm_90a).
//
// Replaces the affine conversion at the end of the JAX package's API,
// ecsimd_tpu/curves/point.py:JacobianPoint.to_affine, which runs as plain
// XLA there (no Pallas kernel) and shares one inversion across the batch
// (GFp.batch_inverse, Montgomery's trick). Its plain PyTorch version,
// curves/point.py:JacobianPoint.to_affine, does the same through a product
// tree, which eager PyTorch runs as thousands of small launches; here the
// trick costs no launch. Each thread takes G lanes (16, but 8 on P-521;
// 4 in a batch too small to fill the card at G), forms their z values'
// prefix products, inverts their product once and unwinds it, 3
// multiplies a lane (affine_lane.cuh); on P-384 and P-521 a block's 128
// threads also share that one inversion (a block tree). Then x
// / z^2 and y / z^3 become classical residues (a Montgomery reduction on
// secp256k1, nothing elsewhere). A lane at infinity (z = 0) gives (0, 0),
// as in the plain version; the residues are canonical, so both agree bit
// for bit.
//
// What bounds it: not the bytes (six planes of D words a lane, z read
// twice) nor the issue slots (a P-256 lane issues about 5,800
// instructions, a sixteenth of the per-lane Fermat power's), but latency:
// at G lanes a thread the batch fills few warps an SM (8 at 524,288 lanes
// and G = 16), and each runs the inversion chain's 255 to 524 dependent
// squarings. A larger G cuts the inversions and the warps together; the
// block tree cuts the inversions alone, and pays where a field operation
// is long (PERF.md). Constant time per lane: every exponent, loop and
// address is public.

#include "field_p256.cuh"
#include "field_p384.cuh"
#include "field_p521.cuh"
#include "field_secp256k1.cuh"
#include "field_w25519.cuh"

namespace p256 {
#include "affine_lane.cuh"
}  // namespace p256

namespace secp256k1 {
#include "affine_lane.cuh"
}  // namespace secp256k1

namespace w25519 {
#include "affine_lane.cuh"
}  // namespace w25519

namespace p384 {
#include "affine_lane.cuh"
}  // namespace p384

namespace p521 {
#include "affine_lane.cuh"
}  // namespace p521

namespace {

constexpr int kThreads = 128;

// Dynamic shared memory a block: the prefixes, G - 1 of N words a thread.
template <int N, int G>
constexpr int smem_bytes() {
  return (G - 1) * N * 4 * kThreads;
}

// Kernel D on NS with G lanes a thread, the inversion a thread's (TREE
// false) or the block's. Lanes past the end of the batch run with the
// others (the block tree's shuffles and barriers need the whole block) and
// store nothing.
#define EC_AFFINE_KERNEL(NAME, NS, G, TREE)                                                \
  __global__ void __launch_bounds__(kThreads)                                              \
  NAME(const int32_t* __restrict__ xs, const int32_t* __restrict__ ys,                     \
       const int32_t* __restrict__ zs, int32_t* __restrict__ ax, int32_t* __restrict__ ay,  \
       int64_t B) {                                                                        \
    extern __shared__ uint32_t smem[];                                                     \
    NS::affine_group<G, TREE, kThreads>(xs, ys, zs, ax, ay, B,                             \
                                        (int64_t)blockIdx.x * kThreads * G, smem);         \
  }

// The lanes a thread of a small batch: a curve's G where its blocks cover
// the card's SMs at least once, else kSmallGroup (at 131,072 lanes, G = 16
// left half the SMs idle and G = 4 ran 11-39 % faster: PERF.md).
constexpr int kSmallGroup = 4;

int group_for(int64_t B, int group) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return B >= (int64_t)sms * kThreads * group ? group : kSmallGroup;
}

// A curve's two kernels, its G and whether its block shares one inversion.
#define EC_AFFINE_KERNELS(TAG, NS, G, TREE)                                                \
  constexpr int kGroup_##TAG = G;                                                          \
  constexpr bool kTree_##TAG = TREE;                                                       \
  EC_AFFINE_KERNEL(affine_##TAG##_kernel, NS, G, TREE)                                     \
  EC_AFFINE_KERNEL(affine_##TAG##_small_kernel, NS, kSmallGroup, TREE)

// G and the inversion a curve, by the card's times at 524,288 lanes
// (PERF.md): on the 256-bit curves 16 lanes a thread, each thread
// inverting its own product (the block tree ran 5-10 % slower there); on
// P-384 16 lanes and on P-521 8, the block sharing one inversion (thread by
// thread ran 21 % and 10 % slower).
EC_AFFINE_KERNELS(p256, p256, 16, false)
EC_AFFINE_KERNELS(secp256k1, secp256k1, 16, false)
EC_AFFINE_KERNELS(w25519, w25519, 16, false)
EC_AFFINE_KERNELS(p384, p384, 16, true)
EC_AFFINE_KERNELS(p521, p521, 8, true)

template <class Kernel>
int launch(Kernel kernel, const int32_t* xs, const int32_t* ys, const int32_t* zs, int32_t* ax,
           int32_t* ay, int64_t B, int group, int smem, void* stream) {
  if (B > 0) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    const int64_t lanes = (int64_t)kThreads * group;
    const int64_t blocks = (B + lanes - 1) / lanes;
    kernel<<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(xs, ys, zs, ax, ay, B);
  }
  return (int)cudaGetLastError();
}

// A curve's kernel at G (N words) or its small batch's at kSmallGroup, as
// group_for chooses for B.
template <int N, int G, class Kernel>
int launch_curve(Kernel kernel, Kernel small, const int32_t* xs, const int32_t* ys,
                 const int32_t* zs, int32_t* ax, int32_t* ay, int64_t B, void* stream) {
  if (group_for(B, G) == G)
    return launch(kernel, xs, ys, zs, ax, ay, B, G, smem_bytes<N, G>(), stream);
  return launch(small, xs, ys, zs, ax, ay, B, kSmallGroup, smem_bytes<N, kSmallGroup>(), stream);
}

}  // namespace

// xs, ys, zs: (D, B) int32 Jacobian digit planes (internal form; D = 16,
// or 24 on P-384 and 33 on P-521); ax, ay: (D, B) classical affine outputs.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int ec_affine_p256(const int32_t* xs, const int32_t* ys, const int32_t* zs,
                              int32_t* ax, int32_t* ay, int64_t B, void* stream) {
  return launch_curve<p256::kWords, kGroup_p256>(affine_p256_kernel, affine_p256_small_kernel,
                                                 xs, ys, zs, ax, ay, B, stream);
}

extern "C" int ec_affine_secp256k1(const int32_t* xs, const int32_t* ys, const int32_t* zs,
                                   int32_t* ax, int32_t* ay, int64_t B, void* stream) {
  return launch_curve<secp256k1::kWords, kGroup_secp256k1>(
      affine_secp256k1_kernel, affine_secp256k1_small_kernel, xs, ys, zs, ax, ay, B, stream);
}

extern "C" int ec_affine_w25519(const int32_t* xs, const int32_t* ys, const int32_t* zs,
                                int32_t* ax, int32_t* ay, int64_t B, void* stream) {
  return launch_curve<w25519::kWords, kGroup_w25519>(
      affine_w25519_kernel, affine_w25519_small_kernel, xs, ys, zs, ax, ay, B, stream);
}

extern "C" int ec_affine_p384(const int32_t* xs, const int32_t* ys, const int32_t* zs,
                              int32_t* ax, int32_t* ay, int64_t B, void* stream) {
  return launch_curve<p384::kWords, kGroup_p384>(affine_p384_kernel, affine_p384_small_kernel,
                                                 xs, ys, zs, ax, ay, B, stream);
}

extern "C" int ec_affine_p521(const int32_t* xs, const int32_t* ys, const int32_t* zs,
                              int32_t* ax, int32_t* ay, int64_t B, void* stream) {
  return launch_curve<p521::kWords, kGroup_p521>(affine_p521_kernel, affine_p521_small_kernel,
                                                 xs, ys, zs, ax, ay, B, stream);
}

// A curve's lanes a thread at B and whether its block shares one inversion.
#define EC_AFFINE_QUERIES(TAG)                                                             \
  extern "C" int ec_affine_##TAG##_group(int64_t B) { return group_for(B, kGroup_##TAG); } \
  extern "C" int ec_affine_##TAG##_tree(void) { return kTree_##TAG ? 1 : 0; }

EC_AFFINE_QUERIES(p256)
EC_AFFINE_QUERIES(secp256k1)
EC_AFFINE_QUERIES(w25519)
EC_AFFINE_QUERIES(p384)
EC_AFFINE_QUERIES(p521)

// The threads a block: thread t of block b takes lanes b kThreads G + t + j
// kThreads, j < G (the curve's `_group`); `_tree` says whether the block
// shares one inversion.
extern "C" int ec_affine_threads(void) { return kThreads; }
