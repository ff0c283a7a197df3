// The comb's table read on the tensor cores, for kernels B (comb.cu,
// comb_p384.cu, comb_p521.cu), J (comb_tree*.cu), K (comb_pipe*.cu) and the
// generic kernel L (comb_general*.cu) on every curve (sm_90a): the host's u8
// layout, its staging into shared memory, the warp-collective one-hot
// product that selects each lane's entry, and the kernel templates of B
// and K and their launcher. Field-independent and width-generic over
// ec::fe_t<N>; the lanes that call it are comb_mma_lane.cuh's and
// comb_pipe_lane.cuh's, inside each field's namespace. Only the templated
// L keeps comb_scan.cuh's masked scan.
//
// Layout (kernels/comb.mma_layout): position j is a u8 matrix of 8 N rows
// and K columns, K-major: row n holds byte n of every entry of the
// position, the entry's x limbs then its y limbs (N 32-bit words each,
// little-endian, no padding), and column k is entry k. Position 0 has K =
// 256 entries, every other position K = 128 magnitudes; the positions are
// contiguous, position 0 first. An entry is 64 bytes at 256 bits, 96 on
// P-384 and 136 on P-521.
//
// The selection. A warp's 32 lanes are the rows of two m16 tiles (lane 16
// mt + m is row m of tile mt). For each k-step of 32 entries the A operand
// is the lanes' one-hot rows, the B operand 8 rows of the staged position,
// and mma.sync.m16n8k32.u8.u8.s32 sums one nonzero term a column: the
// selected byte, exactly. A position is kKSteps = K / 32 k-steps (4, or 8
// for position 0) times N n-tiles of 8 bytes (8, 12 or 17), for each of
// the two m-tiles. Thread (g, t) = (lane / 4, lane % 4) holds, in each
// m-tile's A fragment, rows g and g + 8 at columns 4 t .. 4 t + 3 and
// 16 + 4 t .. 16 + 4 t + 3 of the k-step: it fetches the indices of lanes
// g + 8 r, r = 0..3, with __shfl_sync and builds the four registers by
// compares and shifts. ldmatrix.x4 reads the B fragments of two k-steps
// (four 8 x 16-byte matrices) at once. The accumulators of an n-tile hold
// bytes 2 t and 2 t + 1 of rows g and g + 8 of each m-tile: packed into
// 16-bit halves, they go to the warp's row buffer (shared memory, 32 rows
// of 8 bytes, two slots used in turn), and each lane reads its own 8
// bytes back, words 2 nt and 2 nt + 1 of its entry. One n-tile at a time,
// so that no more than 8 accumulators are live beside the chain.
//
// Bank conflicts: the staging writes each row's 16-byte chunk c to chunk
// c ^ (row & 7) of the row, so the 8 rows an ldmatrix matrix reads hit 8
// different chunks of one 128-byte line; the row buffer's 16-bit stores
// of one instruction fall on 16 consecutive words, its 8-byte reads on 64.
//
// Constant time, memory accesses included: no address and no branch
// depends on the scalar. The table is staged whole (cp.async, 16 bytes a
// request, at addresses from the position and the thread id); the
// ldmatrix addresses come from the position, the n-tile, the k-step and
// the thread id; the row buffer's from the n-tile and the thread id; the
// shuffles' source lanes from the thread id. A lane's index enters only
// the one-hot registers, by compares, masks and a shift. Every thread of
// the warp runs every mma.sync (lanes past the batch run the last lane and
// skip only the store), and the branches around the selection (position 0
// or not, a chain's reseed) depend on loop counters alone.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "comb_scan.cuh"
#include "limbs.cuh"
#include "smem.cuh"

namespace comb_mma {

using comb::kEntries0;
using comb::kHalfEntries;
using comb::kThreads;

// The row buffer: per warp, two slots of 32 rows of 8 bytes.
constexpr int kRowWords = 2 * 32 * 2;
constexpr int kRowBytes = kThreads / 32 * kRowWords * 4;

// Sizes at N words a coordinate: the bytes of an entry (the rows of a
// position's matrix, N n-tiles of 8), position 0's and another position's
// bytes (staged as they are laid out, only swizzled).
template <int N>
struct Layout {
  static constexpr int kEntryBytes = 8 * N;
  static constexpr int kBytes0 = kEntryBytes * kEntries0;
  static constexpr int kBytes = kEntryBytes * kHalfEntries;
};

// The bytes of kernel B's and kernel K's shared memory: position 0's
// buffer (also every even position's), the odd positions' buffer, the row
// buffers.
template <int N>
constexpr int serial_bytes() {
  return Layout<N>::kBytes0 + Layout<N>::kBytes + kRowBytes;
}

// Start copying position j into `buf`, 16 bytes a request spread over the
// block's threads, chunk c of row n to chunk c ^ (n & 7); commit_staged()
// closes the group.
template <int N>
__device__ __forceinline__ void stage_copy(const uint8_t* tables, int j, uint8_t* buf) {
  using L = Layout<N>;
  const int shift = j == 0 ? 4 : 3;  // log2 of the 16-byte chunks a row
  const uint4* src =
      reinterpret_cast<const uint4*>(tables + (j == 0 ? 0 : L::kBytes0 + (j - 1) * L::kBytes));
  const int chunks = L::kEntryBytes << shift;
  uint4* dst = reinterpret_cast<uint4*>(buf);
  for (int q = threadIdx.x; q < chunks; q += blockDim.x) {
    const int row = q >> shift;
    const unsigned to = (unsigned)__cvta_generic_to_shared(dst + (q ^ (row & 7)));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(to), "l"(src + q)
                 : "memory");
  }
}

// Position j as one group of copies.
template <int N>
__device__ __forceinline__ void stage_position(const uint8_t* tables, int j, uint8_t* buf) {
  stage_copy<N>(tables, j, buf);
  comb::commit_staged();
}

// The calling warp's row buffer, in the block's row buffers at `rows`.
__device__ __forceinline__ uint32_t* warp_rows(uint8_t* rows) {
  return reinterpret_cast<uint32_t*>(rows) + (threadIdx.x >> 5) * kRowWords;
}

// d += a b: one m16n8k32 product, u8 x u8 -> s32.
__device__ __forceinline__ void mma_u8(uint32_t (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 16-byte matrices from shared memory, this thread giving the
// address of row lane % 8 of matrix lane / 8 and receiving its share of each.
__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// Warp-collective: entry `idx` (this lane's; < 32 kKSteps) of the position
// staged at `pos` (K = 32 kKSteps entries), into (x, y), through the warp's
// row buffer `rows`. Every lane of the warp calls it together.
template <int N, int kKSteps>
__device__ __forceinline__ void select(const uint8_t* pos, uint32_t idx, uint32_t* rows,
                                       ec::fe_t<N>& x, ec::fe_t<N>& y) {
  constexpr int K = 32 * kKSteps;
  const uint32_t lane = threadIdx.x & 31u, g = lane >> 2, t = lane & 3u;
  // The one-hot A fragments: a[mt][ks] for rows g (regs 0, 2) and g + 8
  // (regs 1, 3) of m-tile mt, columns 4 t + (16 h) .. of k-step ks.
  uint32_t a[2][kKSteps][4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const uint32_t e = __shfl_sync(0xFFFFFFFFu, idx, (int)(g + 8u * r));
    const uint32_t v = (uint32_t)(((e >> 2) & 3u) == t) << ((e & 3u) * 8u);
    const uint32_t key = e >> 4;  // k-step 2 ks + h: 16-column half h of k-step ks
#pragma unroll
    for (int ks = 0; ks < kKSteps; ++ks) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        a[r >> 1][ks][(r & 1) + 2 * h] = v & (0u - (uint32_t)(key == (uint32_t)(2 * ks + h)));
      }
    }
  }
  // ldmatrix: row lane % 8 of an n-tile, chunk 4 p + lane / 8 of k-step pair
  // p, swizzled as the staging wrote it
  const uint32_t base = (uint32_t)__cvta_generic_to_shared(pos) + (lane & 7u) * K;
  uint32_t chunk[kKSteps / 2];
#pragma unroll
  for (int p = 0; p < kKSteps / 2; ++p) {
    chunk[p] = base + 16u * ((4u * p + (lane >> 3)) ^ (lane & 7u));
  }
  uint16_t* half = reinterpret_cast<uint16_t*>(rows);
  __syncwarp();  // the last read of the row buffer (the previous selection) is done
#pragma unroll
  for (int nt = 0; nt < N; ++nt) {
    uint32_t d[2][4] = {{0u, 0u, 0u, 0u}, {0u, 0u, 0u, 0u}};
#pragma unroll
    for (int p = 0; p < kKSteps / 2; ++p) {
      uint32_t b[4];
      ldmatrix_x4(chunk[p] + nt * 8 * K, b);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        mma_u8(d[mt], a[mt][2 * p], b[0], b[1]);
        mma_u8(d[mt], a[mt][2 * p + 1], b[2], b[3]);
      }
    }
    // bytes 2 t, 2 t + 1 of rows g, g + 8 of each m-tile -> the slot's rows
    uint16_t* slot = half + (nt & 1) * 128;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      slot[(16 * mt + g) * 4 + t] = (uint16_t)(d[mt][0] | (d[mt][1] << 8));
      slot[(16 * mt + g + 8) * 4 + t] = (uint16_t)(d[mt][2] | (d[mt][3] << 8));
    }
    __syncwarp();
    const uint2 w = reinterpret_cast<const uint2*>(rows + (nt & 1) * 64)[lane];
    if (2 * nt < N) {
      x.v[2 * nt] = w.x;
    } else {
      y.v[2 * nt - N] = w.x;
    }
    if (2 * nt + 1 < N) {
      x.v[2 * nt + 1] = w.y;
    } else {
      y.v[2 * nt + 1 - N] = w.y;
    }
  }
}

}  // namespace comb_mma

namespace {

// Kernel B: lanes past the end of the batch run the chain on the last lane
// and store nothing: every thread takes part in the block's staging,
// barriers and products.
#define EC_COMB_MMA_KERNEL(NAME, NS, STRICT)                                               \
  __global__ void __launch_bounds__(comb::kThreads)                                        \
  NAME(const int32_t* __restrict__ scalars, const uint8_t* __restrict__ tables,            \
       const int32_t* __restrict__ negbase, int32_t* __restrict__ ax,                      \
       int32_t* __restrict__ ay, int32_t* __restrict__ z, int64_t B) {                     \
    extern __shared__ uint4 smem[];                                                        \
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;                      \
    NS::comb_mma_lane<STRICT>(scalars, tables, negbase, ax, ay, z, B, i < B ? i : B - 1,   \
                              i < B, reinterpret_cast<uint8_t*>(smem));                    \
  }

// Kernel K, the pipelined chain (comb_pipe_lane.cuh), in kernel B's shape:
// the same arguments, shared memory and launcher.
#define EC_COMB_PIPE_KERNEL(NAME, NS)                                                      \
  __global__ void __launch_bounds__(comb::kThreads)                                        \
  NAME(const int32_t* __restrict__ scalars, const uint8_t* __restrict__ tables,            \
       const int32_t* __restrict__ negbase, int32_t* __restrict__ ax,                      \
       int32_t* __restrict__ ay, int32_t* __restrict__ z, int64_t B) {                     \
    extern __shared__ uint4 smem[];                                                        \
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;                      \
    NS::comb_pipe_lane(scalars, tables, negbase, ax, ay, z, B, i < B ? i : B - 1, i < B,   \
                       reinterpret_cast<uint8_t*>(smem));                                  \
  }

// Launch kernel B or K (N words a coordinate) on `stream` with its buffers
// as dynamic shared memory; return cudaGetLastError() (or the attribute's
// error).
template <int N, class Kernel>
int launch_serial(Kernel kernel, const int32_t* scalars, const uint8_t* tables,
                  const int32_t* negbase, int32_t* ax, int32_t* ay, int32_t* z, int64_t B,
                  void* stream) {
  if (B > 0) {
    constexpr int bytes = comb_mma::serial_bytes<N>();
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    const int64_t blocks = (B + comb::kThreads - 1) / comb::kThreads;
    kernel<<<(unsigned)blocks, comb::kThreads, bytes, (cudaStream_t)stream>>>(
        scalars, tables, negbase, ax, ay, z, B);
  }
  return (int)cudaGetLastError();
}

}  // namespace
