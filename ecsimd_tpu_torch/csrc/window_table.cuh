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
// At N words (the Split table below: P-384's 12, P-521's 17) the table of
// a thread is 1,152 or 1,568 bytes (P-521's top words packed), more than
// the 908 bytes a thread that 256 threads an SM (eight warps) leave in
// the SM's 227 KiB. So its first entries sit in shared memory and the rest in
// a scratch in device memory, which stays resident in L2 (Split says how).
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

// --- P-384 and P-521: the table split between shared memory and a scratch
//
// An entry's whole words (x, y, z words 0 .. 4C-1, C = N / 4) are 3C
// vectors: 9 at N = 12, 12 at N = 17. P-521's word 16 holds 9 bits of a
// canonical residue (every field function returns one, and the inputs are
// canonical), so an entry's three top words pack into one 32-bit word
// (x | y << 9 | z << 18) and the eight entries' packed words into two
// vectors. Entries 0 .. K-1 and the packed top words live in shared
// memory: row q of entry t at smem[t * 3C + q][threadIdx.x], the top words
// at rows 3C K and 3C K + 1. Entries K .. 7 live in the scratch, a device
// buffer laid out [vector][slot]: vector q of entry t at row (t - K) 3C + q,
// column `slot`, so a warp's load of one vector reads 512 contiguous bytes.
// The kernel runs a persistent grid whose threads are the scratch's slots
// (window.cuh): each walks its lanes and reuses its own column, written by
// the same thread before it is read, so the scratch is read with plain
// coherent loads (ld.global, never the read-only path) and needs no
// barrier; at 33,792 slots (132 SMs x 256 threads) it is 26 MB on P-521 at
// K = 4 and 10 MB on P-384 at K = 6, inside the 50 MB L2.
//
// The scan reads all eight entries, on chip and off, and keeps one with
// masks: every address depends on the entry number, the vector and the
// slot only, never on the secret index.

template <int N>
__host__ __device__ constexpr int whole_vecs() {
  return 3 * (N / 4);
}

template <int N>
__host__ __device__ constexpr int top_vecs() {
  static_assert(N % 4 == 0 || N == 17, "a top word packs only at P-521's 9 bits");
  return N % 4 ? kEntries / 4 : 0;
}

// The table of a block of kThreads threads at N words with K entries on
// chip: the block's shared rows and this thread's scratch column.
template <int N, int K>
struct Split {
  static_assert(0 <= K && K <= kEntries, "entries on chip");
  static constexpr int kVecs = whole_vecs<N>();
  static constexpr int kTopRow = K * kVecs;
  static constexpr int kSmemRows = K * kVecs + top_vecs<N>();
  static constexpr int kScratchRows = (kEntries - K) * kVecs;
  static constexpr int kSmemBytes = kSmemRows * kThreads * (int)sizeof(uint4);

  uint4 (*smem)[kThreads];  // kSmemRows rows of the block's thread columns
  uint4* scratch;           // kScratchRows rows of `slots` columns
  int64_t slots;
  int64_t slot;             // this thread's column
};

template <int N>
__device__ __forceinline__ uint4 quad(const ec::fe_t<N>& a, int q) {
  return make_uint4(a.v[4 * q], a.v[4 * q + 1], a.v[4 * q + 2], a.v[4 * q + 3]);
}

template <int N>
__device__ __forceinline__ void or_quad(ec::fe_t<N>& a, int q, const uint4& v, uint32_t mask) {
  a.v[4 * q] |= v.x & mask;
  a.v[4 * q + 1] |= v.y & mask;
  a.v[4 * q + 2] |= v.z & mask;
  a.v[4 * q + 3] |= v.w & mask;
}

// Entry t (public: the table loop's counter) of this thread's table.
template <int N, int K>
__device__ __forceinline__ void put(Split<N, K>& tbl, int t, const ec::fe_t<N>& x,
                                    const ec::fe_t<N>& y, const ec::fe_t<N>& z) {
  constexpr int C = N / 4, V = Split<N, K>::kVecs;
  const int j = threadIdx.x;
  if (t < K) {
    uint4(*e)[kThreads] = tbl.smem + t * V;
#pragma unroll
    for (int q = 0; q < C; ++q) {
      e[q][j] = quad(x, q);
      e[C + q][j] = quad(y, q);
      e[2 * C + q][j] = quad(z, q);
    }
  } else {
    uint4* e = tbl.scratch + (int64_t)(t - K) * V * tbl.slots + tbl.slot;
#pragma unroll
    for (int q = 0; q < C; ++q) {
      e[q * tbl.slots] = quad(x, q);
      e[(C + q) * tbl.slots] = quad(y, q);
      e[(2 * C + q) * tbl.slots] = quad(z, q);
    }
  }
  if constexpr (top_vecs<N>() > 0) {
    uint32_t* top = reinterpret_cast<uint32_t*>(&tbl.smem[Split<N, K>::kTopRow + (t >> 2)][j]);
    top[t & 3] = x.v[N - 1] | y.v[N - 1] << 9 | z.v[N - 1] << 18;
  }
}

// Entry idx of this thread's table, reading every entry: constant time.
template <int N, int K>
__device__ __forceinline__ void get(const Split<N, K>& tbl, uint32_t idx, ec::fe_t<N>& x,
                                    ec::fe_t<N>& y, ec::fe_t<N>& z) {
  constexpr int C = N / 4, V = Split<N, K>::kVecs;
  const int j = threadIdx.x;
  x = ec::zero_n<N>();
  y = ec::zero_n<N>();
  z = ec::zero_n<N>();
#pragma unroll
  for (int t = 0; t < K; ++t) {
    const uint32_t mask = 0u - (uint32_t)(idx == (uint32_t)t);
    const uint4(*e)[kThreads] = tbl.smem + t * V;
#pragma unroll
    for (int q = 0; q < C; ++q) {
      or_quad(x, q, e[q][j], mask);
      or_quad(y, q, e[C + q][j], mask);
      or_quad(z, q, e[2 * C + q][j], mask);
    }
  }
#pragma unroll
  for (int t = K; t < kEntries; ++t) {
    const uint32_t mask = 0u - (uint32_t)(idx == (uint32_t)t);
    const uint4* e = tbl.scratch + (int64_t)(t - K) * V * tbl.slots + tbl.slot;
#pragma unroll
    for (int q = 0; q < C; ++q) {
      or_quad(x, q, e[q * tbl.slots], mask);
      or_quad(y, q, e[(C + q) * tbl.slots], mask);
      or_quad(z, q, e[(2 * C + q) * tbl.slots], mask);
    }
  }
  if constexpr (top_vecs<N>() > 0) {
    uint32_t top = 0u;
#pragma unroll
    for (int h = 0; h < kEntries / 4; ++h) {
      const uint4 v = tbl.smem[Split<N, K>::kTopRow + h][j];
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int r = 0; r < 4; ++r) top |= w[r] & (0u - (uint32_t)(idx == (uint32_t)(4 * h + r)));
    }
    x.v[N - 1] = top & 0x1FFu;
    y.v[N - 1] = top >> 9 & 0x1FFu;
    z.v[N - 1] = top >> 18;
  }
}

}  // namespace wtable
