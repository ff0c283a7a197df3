// The per-lane table of kernels E (window.cu) and F (glv.cu): eight Jacobian
// entries (x, y, z) per thread in shared memory, written once and read by a
// constant-time masked scan (sm_90a).
//
// An entry is 24 32-bit words, six 16-byte vectors: x words 0..3 and 4..7,
// then y's, then z's. Vector q of entry t of thread j sits at
// tbl[t * 6 + q][j], so a warp's 32 threads read 32 consecutive 16-byte
// slots with one ld.shared.v4.u32 each: four wavefronts, no bank conflict,
// and 48 loads a lookup where 32-bit words took 192. The table is 768 bytes
// a thread, 48 KiB for a block of 64 threads (the static limit), four
// blocks per SM; it cannot sit in registers beside the accumulator and the
// field temporaries (255 registers at most), and in local memory the ~300
// resident threads' tables would stream from L2 on every lookup.
//
// The scan reads all eight entries and keeps one with masks: no address or
// branch depends on the secret index. Each thread reads only its own
// column, so no barrier is needed. TMA has nothing to stream here: the
// table is built in the kernel from 32 words of input a lane.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "limbs.cuh"

namespace wtable {

constexpr int kThreads = 64;  // threads a block
constexpr int kEntries = 8;   // odd multiples P, 3P, .., 15P
constexpr int kVecs = 6;      // 16-byte vectors an entry

typedef uint4 Table[kEntries * kVecs][kThreads];

// Half h (words 4h .. 4h+3) of a as one vector, and back, masked.
__device__ __forceinline__ uint4 half(const ec::fe& a, int h) {
  return make_uint4(a.v[4 * h], a.v[4 * h + 1], a.v[4 * h + 2], a.v[4 * h + 3]);
}

__device__ __forceinline__ void or_half(ec::fe& a, int h, const uint4& v, uint32_t mask) {
  a.v[4 * h] |= v.x & mask;
  a.v[4 * h + 1] |= v.y & mask;
  a.v[4 * h + 2] |= v.z & mask;
  a.v[4 * h + 3] |= v.w & mask;
}

__device__ __forceinline__ void put(Table& tbl, int t, const ec::fe& x, const ec::fe& y,
                                    const ec::fe& z) {
  const int j = threadIdx.x;
  uint4(*e)[kThreads] = tbl + t * kVecs;
  e[0][j] = half(x, 0);
  e[1][j] = half(x, 1);
  e[2][j] = half(y, 0);
  e[3][j] = half(y, 1);
  e[4][j] = half(z, 0);
  e[5][j] = half(z, 1);
}

// Entry idx of this thread's table, reading every entry: constant time.
__device__ __forceinline__ void get(const Table& tbl, uint32_t idx, ec::fe& x, ec::fe& y,
                                    ec::fe& z) {
  const int j = threadIdx.x;
  x = ec::fe_zero();
  y = ec::fe_zero();
  z = ec::fe_zero();
#pragma unroll
  for (int t = 0; t < kEntries; ++t) {
    const uint32_t mask = 0u - (uint32_t)(idx == (uint32_t)t);
    const uint4(*e)[kThreads] = tbl + t * kVecs;
    or_half(x, 0, e[0][j], mask);
    or_half(x, 1, e[1][j], mask);
    or_half(y, 0, e[2][j], mask);
    or_half(y, 1, e[3][j], mask);
    or_half(z, 0, e[4][j], mask);
    or_half(z, 1, e[5][j], mask);
  }
}

}  // namespace wtable
