// The comb's shared constants, entry index and cp.async groups (sm_90a),
// for kernels B, J, K and the generic L, which stage each position of the
// table in shared memory and select from it on the tensor cores
// (comb_mma.cuh). No address here depends on the scalar: a position is
// copied whole (cp.async, 16 bytes a request).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace comb {

constexpr int kPositions = 32;     // the 256-bit curves
constexpr int kEntries0 = 256;     // position 0
constexpr int kHalfEntries = 128;  // positions 1 .. npos - 1
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

// Close the group of the copies started since the last one.
__device__ __forceinline__ void commit_staged() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most `kPending` staged positions are still in flight.
template <int kPending>
__device__ __forceinline__ void wait_staged() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

}  // namespace comb
