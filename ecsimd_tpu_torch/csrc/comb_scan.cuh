// The comb's shared constants, entry index and cp.async groups, and the
// templated kernel L's staging and masked scan (sm_90a). Kernels B, J, K
// and the generic L take only the constants, entry_index and the groups
// (their read: comb_mma.cuh); since they select on the tensor cores, the
// staging and scan here, and their table (kernels/comb.kernel_tables: an
// entry is the x limbs then the y limbs, 16 32-bit words at 256 bits),
// serve the templated L alone (comb_chains.cuh, 256-bit curves only). The
// sign of an entry of positions 1 .. 31 and the choice of scan per
// position are in comb_chains_lane.cuh, inside each field's namespace.
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

// Start copying position j's entries (kEntryVecs vectors each) into `buf`,
// 16 bytes per request, spread over the block's threads; commit_staged()
// closes the group.
__device__ __forceinline__ void stage_copy(const uint4* tables, int j, uint4* buf) {
  const int first = j == 0 ? 0 : kEntries0 + (j - 1) * kHalfEntries;
  const int vecs = (j == 0 ? kEntries0 : kHalfEntries) * kEntryVecs;
  const uint4* src = tables + (int64_t)first * kEntryVecs;
  for (int q = threadIdx.x; q < vecs; q += blockDim.x) {
    const unsigned dst = (unsigned)__cvta_generic_to_shared(buf + q);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src + q)
                 : "memory");
  }
}

__device__ __forceinline__ void commit_staged() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
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

}  // namespace comb
