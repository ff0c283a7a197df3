// The per-lane table of kernels E (window*.cu) and F (glv.cu): eight
// Jacobian entries (x, y, z) per thread in shared memory, written once and
// read by a constant-time masked scan (sm_90a).
//
// At 8 words an entry is 24 32-bit words, six 16-byte vectors: x words
// 0..3 and 4..7, then y's, then z's. Vector q of entry t of thread j sits at
// tbl[t * 6 + q][j], so a warp's 32 threads read 32 consecutive 16-byte
// slots with one ld.shared.v4.u32 each: four wavefronts, no bank conflict,
// and 48 loads a lookup where 32-bit words took 192. The table is 768 bytes
// a thread, 48 KiB for a block of 64 threads (the static limit), four
// blocks per SM; it cannot sit in registers beside the accumulator and the
// field temporaries (255 registers at most), and in local memory the ~300
// resident threads' tables would stream from L2 on every lookup.
//
// At N words (the templates below: P-384's 12, P-521's 17) a coordinate is
// padded to a whole number of vectors (12 words: 3 vectors; 17: 5 vectors,
// words 17..19 zero and never read), so an entry is 9 or 15 vectors, 1,152
// or 1,920 bytes of table a thread: above the 48 KiB of static shared
// memory for 64 threads. Those kernels take the table as dynamic shared
// memory (window.cuh says how much and with how many threads a block).
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

// --- any width: put and get of a table of T thread columns, entries of
// vecs<N>() vectors (the 8-word ones above are picked first at N = 8)

template <int N>
__host__ __device__ constexpr int coord_vecs() {
  return ec::padded_words<N>() / 4;
}

template <int N>
__host__ __device__ constexpr int vecs() {
  return 3 * coord_vecs<N>();
}

// Words 4q .. 4q+3 of a as one vector, zero past word N - 1.
template <int N>
__device__ __forceinline__ uint4 quad(const ec::fe_t<N>& a, int q) {
  const uint32_t* v = a.v;
  return make_uint4(v[4 * q], 4 * q + 1 < N ? v[4 * q + 1] : 0u,
                    4 * q + 2 < N ? v[4 * q + 2] : 0u, 4 * q + 3 < N ? v[4 * q + 3] : 0u);
}

template <int N>
__device__ __forceinline__ void or_quad(ec::fe_t<N>& a, int q, const uint4& v, uint32_t mask) {
  a.v[4 * q] |= v.x & mask;
  if (4 * q + 1 < N) a.v[4 * q + 1] |= v.y & mask;
  if (4 * q + 2 < N) a.v[4 * q + 2] |= v.z & mask;
  if (4 * q + 3 < N) a.v[4 * q + 3] |= v.w & mask;
}

// tbl: the block's table, kEntries * vecs<N>() rows of T thread columns.
template <int N, int R, int T>
__device__ __forceinline__ void put(uint4 (&tbl)[R][T], int t, const ec::fe_t<N>& x,
                                    const ec::fe_t<N>& y, const ec::fe_t<N>& z) {
  static_assert(R == kEntries * vecs<N>(), "a table of eight entries");
  constexpr int C = coord_vecs<N>();
  const int j = threadIdx.x;
  uint4(*e)[T] = tbl + t * vecs<N>();
#pragma unroll
  for (int q = 0; q < C; ++q) {
    e[q][j] = quad(x, q);
    e[C + q][j] = quad(y, q);
    e[2 * C + q][j] = quad(z, q);
  }
}

// Entry idx of this thread's table, reading every entry: constant time.
template <int N, int R, int T>
__device__ __forceinline__ void get(const uint4 (&tbl)[R][T], uint32_t idx, ec::fe_t<N>& x,
                                    ec::fe_t<N>& y, ec::fe_t<N>& z) {
  constexpr int C = coord_vecs<N>();
  const int j = threadIdx.x;
  x = ec::zero_n<N>();
  y = ec::zero_n<N>();
  z = ec::zero_n<N>();
#pragma unroll
  for (int t = 0; t < kEntries; ++t) {
    const uint32_t mask = 0u - (uint32_t)(idx == (uint32_t)t);
    const uint4(*e)[T] = tbl + t * vecs<N>();
#pragma unroll
    for (int q = 0; q < C; ++q) {
      or_quad(x, q, e[q][j], mask);
      or_quad(y, q, e[C + q][j], mask);
      or_quad(z, q, e[2 * C + q][j], mask);
    }
  }
}

}  // namespace wtable
