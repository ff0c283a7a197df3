// Staging and masked scan of the comb's table positions, shared by kernels
// J (comb_tree*.cu), K (comb_pipe*.cu) and the templated L (comb_chains.cuh)
// on every curve (sm_90a); kernel B and the generic L take only its
// constants, entry_index and cp.async groups (their read: comb_mma.cuh).
// Field-independent: an entry is the x limbs then the y limbs
// (kernels/comb.kernel_tables), each coordinate padded to whole 16-byte
// vectors — 16 32-bit words at 8 words a coordinate (the constants
// below, which J, K and L use), 24 on P-384 and 40 on P-521 (Layout<N>:
// 17 words and 3 zero words a coordinate). The sign of an entry of
// positions 1 .. npos - 1 and the choice of scan per position are in
// comb_lane.cuh, inside each field's namespace.
//
// No address here depends on the scalar: a position is copied whole into
// shared memory (cp.async, 16 bytes a request) and every thread reads every
// entry of it, keeping the one it wants by masks.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "limbs.cuh"

namespace comb {

constexpr int kPositions = 32;                 // the 256-bit curves
constexpr int kEntries0 = 256;                 // position 0
constexpr int kHalfEntries = 128;              // positions 1 .. npos - 1
constexpr int kEntryVecs = 4;                  // 16 words: x limbs, then y limbs
constexpr int kBufVecs = kEntries0 * kEntryVecs;  // 16 KiB, the largest position
constexpr int kThreads = 128;

// The layout at N words a coordinate: 16-byte vectors a coordinate, an
// entry, and the largest position (position 0).
template <int N>
struct Layout {
  static constexpr int kCoordVecs = ec::padded_words<N>() / 4;
  static constexpr int kEntryVecs = 2 * kCoordVecs;
  static constexpr int kBufVecs = kEntries0 * kEntryVecs;
};

// Entry index of position j: bits 8j .. 8j+8 of the scalar, shifted right
// by one (bit 16 D reads as 0).
template <int D = 16>
__device__ __forceinline__ uint32_t entry_index(const int32_t* scalars, int64_t B, int64_t i,
                                                int j) {
  const int digit = (8 * j) / 16;
  const int off = (8 * j) % 16;
  uint32_t w = ((uint32_t)scalars[digit * B + i] & 0xFFFFu) >> off;
  if (off + 9 > 16 && digit + 1 < D) {
    w |= ((uint32_t)scalars[(digit + 1) * B + i] & 0xFFFFu) << (16 - off);
  }
  return (w & 0x1FFu) >> 1;
}

// Start copying position j's entries (kEV vectors each) into `buf`, 16
// bytes per request, spread over the block's threads; commit_staged()
// closes the group.
template <int kEV = kEntryVecs>
__device__ __forceinline__ void stage_copy(const uint4* tables, int j, uint4* buf) {
  const int first = j == 0 ? 0 : kEntries0 + (j - 1) * kHalfEntries;
  const int vecs = (j == 0 ? kEntries0 : kHalfEntries) * kEV;
  const uint4* src = tables + (int64_t)first * kEV;
  for (int q = threadIdx.x; q < vecs; q += blockDim.x) {
    const unsigned dst = (unsigned)__cvta_generic_to_shared(buf + q);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src + q)
                 : "memory");
  }
}

__device__ __forceinline__ void commit_staged() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Position j as one group of copies.
template <int kEV = kEntryVecs>
__device__ __forceinline__ void stage_position(const uint4* tables, int j, uint4* buf) {
  stage_copy<kEV>(tables, j, buf);
  commit_staged();
}

// Wait until at most `kPending` staged positions are still in flight.
template <int kPending>
__device__ __forceinline__ void wait_staged() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Entry `idx` of the n staged entries, reading every entry with masks.
template <int kN>
__device__ __forceinline__ void scan(const uint4* buf, uint32_t idx, ec::fe& x, ec::fe& y) {
  x = ec::fe_zero();
  y = ec::fe_zero();
#pragma unroll 4
  for (int e = 0; e < kN; ++e) {
    const uint32_t mask = 0u - (uint32_t)(idx == (uint32_t)e);
    const uint4 q0 = buf[e * kEntryVecs], q1 = buf[e * kEntryVecs + 1];
    const uint4 q2 = buf[e * kEntryVecs + 2], q3 = buf[e * kEntryVecs + 3];
    x.v[0] |= q0.x & mask; x.v[1] |= q0.y & mask; x.v[2] |= q0.z & mask; x.v[3] |= q0.w & mask;
    x.v[4] |= q1.x & mask; x.v[5] |= q1.y & mask; x.v[6] |= q1.z & mask; x.v[7] |= q1.w & mask;
    y.v[0] |= q2.x & mask; y.v[1] |= q2.y & mask; y.v[2] |= q2.z & mask; y.v[3] |= q2.w & mask;
    y.v[4] |= q3.x & mask; y.v[5] |= q3.y & mask; y.v[6] |= q3.z & mask; y.v[7] |= q3.w & mask;
  }
}

// The same at N words (picked after the 8-word one above): the padding
// words of each coordinate's last vector are never read.
template <int kN, int N>
__device__ __forceinline__ void scan(const uint4* buf, uint32_t idx, ec::fe_t<N>& x,
                                     ec::fe_t<N>& y) {
  constexpr int C = Layout<N>::kCoordVecs;
  x = ec::zero_n<N>();
  y = ec::zero_n<N>();
#pragma unroll 2
  for (int e = 0; e < kN; ++e) {
    const uint32_t mask = 0u - (uint32_t)(idx == (uint32_t)e);
    const uint4* q = buf + e * 2 * C;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const uint4 qx = q[c], qy = q[C + c];
      x.v[4 * c] |= qx.x & mask;
      y.v[4 * c] |= qy.x & mask;
      if (4 * c + 1 < N) {
        x.v[4 * c + 1] |= qx.y & mask;
        y.v[4 * c + 1] |= qy.y & mask;
      }
      if (4 * c + 2 < N) {
        x.v[4 * c + 2] |= qx.z & mask;
        y.v[4 * c + 2] |= qy.z & mask;
      }
      if (4 * c + 3 < N) {
        x.v[4 * c + 3] |= qx.w & mask;
        y.v[4 * c + 3] |= qy.w & mask;
      }
    }
  }
}

}  // namespace comb
