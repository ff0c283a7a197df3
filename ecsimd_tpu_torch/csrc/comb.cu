// Kernel B: fixed-base comb k_i * B on P-256, one lane per thread (NVIDIA
// Hopper, sm_90a).
//
// Replaces ecsimd_tpu/kernels/comb.py:_comb_kernel (serial chain, one
// accumulator, unroll 1), both strict variants. Width-8 signed-odd comb with no
// doublings: the entry index of position j is e_j = w9_j >> 1, where w9_j
// is the 9-bit window k[8j .. 8j+8]; the accumulator seeds from position
// 0's entry with z = 1 (the recoding's top digit is folded into that
// table), positions 1..31 each add one entry with ADD_Z2_1, and even
// scalars get -B added at the end (k was computed as k + 1). Strict
// (ec_comb_p256_strict): every add, the fix-up included, is add_complete
// against the entry with z = 1, so prefix sums that hit an entry, its
// opposite or infinity stay right, and k = n - 1 gives -B. Same order as
// kernels/comb.comb_plain, so the Jacobian planes agree bit for bit.
//
// Not constant-time in its memory accesses: load_entry's address is the
// secret window (entry_index), where the TPU kernel reads every entry of
// the position through a one-hot product. The arithmetic is uniform.
//
// Tables: int32 (32, 256, 32) — per position and entry, the 16 x-digits
// then the 16 y-digits of an affine point, base 2^16. 1 MiB in all, so the
// whole table stays in the 50 MB L2 cache; each lane gathers 32 entries of
// 128 bytes with plain read-only loads. The TPU's one-hot x table matmul on
// the matrix unit, its int8 biased half-digit tables and its grid axis over
// positions (accumulator in scratch memory, a discarded add at j == 0) were
// workarounds for its memory system; here the positions are a loop inside
// the thread.
//
// What bounds it: 32-bit integer multiply-add throughput (31 + 1 mixed adds
// of 7 field multiplies and 4 squarings each; strict: 31 + 1 complete adds of
// 15 and 9); the
// gathers are L2 hits, 4 KiB per lane.

#include "coz_p256.cuh"

namespace p256 {

constexpr int kPositions = 32;
constexpr int kEntries = 256;
constexpr int kEntryWords = 32;  // 16 x-digits + 16 y-digits

// Entry index of position j: bits 8j .. 8j+8 of the scalar, shifted right
// by one (bit 256 reads as 0).
__device__ __forceinline__ uint32_t entry_index(const int32_t* scalars, int64_t B, int64_t i,
                                                int j) {
  const int digit = (8 * j) / 16;
  const int off = (8 * j) % 16;
  uint32_t w = ((uint32_t)scalars[digit * B + i] & 0xFFFFu) >> off;
  if (off + 9 > 16 && digit + 1 < 16) {
    w |= ((uint32_t)scalars[(digit + 1) * B + i] & 0xFFFFu) << (16 - off);
  }
  return (w & 0x1FFu) >> 1;
}

// Two base-2^16 digit rows -> 8 x 32-bit limbs.
__device__ __forceinline__ fe fe_from_digits(const int32_t* d) {
  fe r;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    r.v[j] = ((uint32_t)d[2 * j] & 0xFFFFu) | ((uint32_t)d[2 * j + 1] << 16);
  }
  return r;
}

// Gather entry e of position j: 128 contiguous bytes, as eight 16-byte
// read-only loads.
__device__ __forceinline__ void load_entry(const int32_t* tables, int j, uint32_t e, fe& x,
                                           fe& y) {
  const int32_t* src = tables + ((int64_t)j * kEntries + e) * kEntryWords;
  int32_t d[kEntryWords];
#pragma unroll
  for (int q = 0; q < kEntryWords / 4; ++q) {
    const int4 v = __ldg(reinterpret_cast<const int4*>(src) + q);
    d[4 * q] = v.x;
    d[4 * q + 1] = v.y;
    d[4 * q + 2] = v.z;
    d[4 * q + 3] = v.w;
  }
  x = fe_from_digits(d);
  y = fe_from_digits(d + 16);
}

// acc + (ex, ey, 1): the mixed add, or the complete add when strict.
template <bool kStrict>
__device__ __forceinline__ void comb_add(fe x1, fe y1, fe z1, fe ex, fe ey, fe& x3, fe& y3,
                                         fe& z3) {
  if constexpr (kStrict) {
    add_complete(x1, y1, z1, ex, ey, fe_from_u32(1u), x3, y3, z3);
  } else {
    add_z2_1(x1, y1, z1, ex, ey, x3, y3, z3);
  }
}

template <bool kStrict>
__device__ __forceinline__ void comb_lane(const int32_t* scalars, const int32_t* tables,
                                          const int32_t* negbase, int32_t* ax_out,
                                          int32_t* ay_out, int32_t* z_out, int64_t B,
                                          int64_t i) {
  fe x, y, ex, ey;
  load_entry(tables, 0, entry_index(scalars, B, i, 0), x, y);
  fe z = fe_from_u32(1u);
  for (int j = 1; j < kPositions; ++j) {
    load_entry(tables, j, entry_index(scalars, B, i, j), ex, ey);
    comb_add<kStrict>(x, y, z, ex, ey, x, y, z);
  }
  // parity fixup: even k computed (k+1)B; add -B
  fe sx, sy, sz;
  comb_add<kStrict>(x, y, z, fe_from_digits(negbase), fe_from_digits(negbase + 16), sx, sy,
                    sz);
  const uint32_t even = ((uint32_t)scalars[i] & 1u) ^ 1u;
  fe_store(ax_out, B, i, fe_select(even, sx, x));
  fe_store(ay_out, B, i, fe_select(even, sy, y));
  fe_store(z_out, B, i, fe_select(even, sz, z));
}

}  // namespace p256

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
comb_p256_kernel(const int32_t* __restrict__ scalars, const int32_t* __restrict__ tables,
                 const int32_t* __restrict__ negbase, int32_t* __restrict__ ax,
                 int32_t* __restrict__ ay, int32_t* __restrict__ z, int64_t B) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  p256::comb_lane<false>(scalars, tables, negbase, ax, ay, z, B, i);
}

__global__ void __launch_bounds__(kThreads)
comb_strict_p256_kernel(const int32_t* __restrict__ scalars, const int32_t* __restrict__ tables,
                        const int32_t* __restrict__ negbase, int32_t* __restrict__ ax,
                        int32_t* __restrict__ ay, int32_t* __restrict__ z, int64_t B) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  p256::comb_lane<true>(scalars, tables, negbase, ax, ay, z, B, i);
}

}  // namespace

// scalars: (16, B) int32 digit planes; tables: (32, 256, 32) int32, 16-byte
// aligned; negbase: 32 int32 digits (x then y) of -B; ax, ay, z: (16, B)
// outputs. Launches on `stream` and returns cudaGetLastError().
extern "C" int ec_comb_p256(const int32_t* scalars, const int32_t* tables,
                            const int32_t* negbase, int32_t* ax, int32_t* ay, int32_t* z,
                            int64_t B, void* stream) {
  if (B > 0) {
    const int64_t blocks = (B + kThreads - 1) / kThreads;
    comb_p256_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        scalars, tables, negbase, ax, ay, z, B);
  }
  return (int)cudaGetLastError();
}

extern "C" int ec_comb_p256_strict(const int32_t* scalars, const int32_t* tables,
                                   const int32_t* negbase, int32_t* ax, int32_t* ay, int32_t* z,
                                   int64_t B, void* stream) {
  if (B > 0) {
    const int64_t blocks = (B + kThreads - 1) / kThreads;
    comb_strict_p256_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        scalars, tables, negbase, ax, ay, z, B);
  }
  return (int)cudaGetLastError();
}
