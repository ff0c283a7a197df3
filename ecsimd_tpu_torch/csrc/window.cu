// Kernel E: signed fixed-window (w = 4) k_i * P_i on P-256, one lane per
// thread (NVIDIA Hopper, sm_90a), plain and strict.
//
// Replaces ecsimd_tpu/kernels/window.py:_window_kernel (core _window_core),
// both strict variants. Same formula sequence as
// kernels/window.window_plain: the lane builds its table T[t] = (2t+1) P,
// t < 8 (one jac_dbl, seven jac_add); the accumulator starts at P (the
// recoding's top digit is 1); then for each 4-bit window, MSB first (bit
// offsets 252 .. 0): four jac_dbl and one add of +-T[idx] — jac_add, or
// add_complete when strict. Window i reads bits 4i .. 4i+4 of k (bit 256
// reads as 0) and recodes them to the odd digit ((w5 | 1) - 16). Even
// scalars then add -P (add_z2_1, or add_complete when strict), since k was
// computed as k | 1. Output: Jacobian (X, Y, Z) planes, bit-identical to
// the plain PyTorch version (every field result is canonical).
//
// Constant time per lane: the lookup reads all eight entries and keeps one
// with masks, the digit's sign is a masked negation, and the strict add
// computes both its add and its doubling; nothing is indexed or branched on
// by the secret scalar.
//
// The per-lane table (768 bytes) lives in shared memory and is read with
// 16-byte loads (window_table.cuh): 48 KiB for a block of 64 threads, four
// blocks per SM; __launch_bounds__(64, 4) holds the registers to that
// occupancy, and both variants fit it without spilling (ptxas -v in phase 1
// of chip_smoke.py).
//
// What bounds it: the integer ALU pipe. A lane issues about 0.86 million
// instructions (1.0 million strict), 73 % of them on the ALU pipe (carry
// chains, the Solinas reduction, selects) and 26 % on the multiply-add
// pipe (bench/sass.py); the 64 table lookups are 3,072 16-byte shared
// loads and the device memory 48 words a lane. The design: one multiply
// core with a dedicated squaring (mul256.cuh), the reduction and the
// modular adds on 32-bit carry chains, the 16-byte table scan, and a live
// set that fits the register file. The tensor cores and TMA do not apply
// (lane-specific operands, no stream of data to copy).

#include "coz_p256.cuh"
#include "window_table.cuh"

namespace p256 {

using wtable::Table;

template <bool kStrict>
__device__ __forceinline__ void window_lane(const int32_t* scalars, const int32_t* xs,
                                            const int32_t* ys, int32_t* ax_out,
                                            int32_t* ay_out, int32_t* z_out, int64_t B,
                                            int64_t i, Table& tbl) {
  const fe one = fe_from_u32(1u);
  fe accx = fe_load(xs, B, i);
  fe accy = fe_load(ys, B, i);
  fe accz = one;

  // table of odd multiples: T[0] = P, T[t] = T[t-1] + 2P
  fe dx, dy, dz, tx = accx, ty = accy, tz = one;
  jac_dbl(accx, accy, one, dx, dy, dz);
  wtable::put(tbl, 0, tx, ty, tz);
#pragma unroll 1
  for (int t = 1; t < wtable::kEntries; ++t) {
    fe h, r;
    jac_add(tx, ty, tz, dx, dy, dz, tx, ty, tz, h, r);
    wtable::put(tbl, t, tx, ty, tz);
  }

#pragma unroll 1
  for (int w = 7; w >= 0; --w) {
    // 64 bits of k from bit 32w: the window at offset 28 spills into word w+1
    const uint64_t kk = (uint64_t)scalar_word(scalars, B, i, w) |
                        ((uint64_t)(w < 7 ? scalar_word(scalars, B, i, w + 1) : 0u) << 32);
#pragma unroll 1
    for (int off = 28; off >= 0; off -= 4) {
      const uint32_t v = ((uint32_t)(kk >> off) & 31u) | 1u;  // digit v - 16, odd
      const uint32_t neg = (v >> 4) ^ 1u;                     // v < 16
      const uint32_t m = 0u - neg;
      const uint32_t mag = ((v - 16u) ^ m) - m;               // |v - 16|, branch-free
#pragma unroll 1
      for (int s = 0; s < 4; ++s) jac_dbl(accx, accy, accz, accx, accy, accz);
      // looked up after the doublings, so the entry is not live across them
      fe ex, ey, ez;
      wtable::get(tbl, (mag - 1u) >> 1, ex, ey, ez);
      ey = fe_select(neg, fe_neg(ey), ey);
      if constexpr (kStrict) {
        add_complete(accx, accy, accz, ex, ey, ez, accx, accy, accz);
      } else {
        fe h, r;
        jac_add(accx, accy, accz, ex, ey, ez, accx, accy, accz, h, r);
      }
    }
  }

  // parity fixup: even scalars got (k+1)P; add -P
  const fe x = fe_load(xs, B, i);
  const fe ny = fe_neg(fe_load(ys, B, i));
  fe sx, sy, sz;
  if constexpr (kStrict) {
    add_complete(accx, accy, accz, x, ny, one, sx, sy, sz);
  } else {
    add_z2_1(accx, accy, accz, x, ny, sx, sy, sz);
  }
  const uint32_t even = (scalar_word(scalars, B, i, 0) & 1u) ^ 1u;
  fe_store(ax_out, B, i, fe_select(even, sx, accx));
  fe_store(ay_out, B, i, fe_select(even, sy, accy));
  fe_store(z_out, B, i, fe_select(even, sz, accz));
}

}  // namespace p256

namespace {

using wtable::kThreads;

// No barrier is needed: each thread reads only its own table column. Four
// blocks of 64 threads an SM: the tables' 4 x 48 KiB of shared memory and
// the register file (255 a thread) both allow no more.
__global__ void __launch_bounds__(kThreads, 4)
window_p256_kernel(const int32_t* __restrict__ scalars, const int32_t* __restrict__ xs,
                   const int32_t* __restrict__ ys, int32_t* __restrict__ ax,
                   int32_t* __restrict__ ay, int32_t* __restrict__ z, int64_t B) {
  __shared__ wtable::Table tbl;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  p256::window_lane<false>(scalars, xs, ys, ax, ay, z, B, i, tbl);
}

__global__ void __launch_bounds__(kThreads, 4)
window_strict_p256_kernel(const int32_t* __restrict__ scalars, const int32_t* __restrict__ xs,
                          const int32_t* __restrict__ ys, int32_t* __restrict__ ax,
                          int32_t* __restrict__ ay, int32_t* __restrict__ z, int64_t B) {
  __shared__ wtable::Table tbl;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  p256::window_lane<true>(scalars, xs, ys, ax, ay, z, B, i, tbl);
}

}  // namespace

// scalars, xs, ys: (16, B) int32 digit planes (affine point, z = 1); ax, ay,
// z: (16, B) Jacobian outputs. Launch on `stream`; return cudaGetLastError().
extern "C" int ec_window_p256(const int32_t* scalars, const int32_t* xs, const int32_t* ys,
                              int32_t* ax, int32_t* ay, int32_t* z, int64_t B,
                              void* stream) {
  if (B > 0) {
    const int64_t blocks = (B + kThreads - 1) / kThreads;
    window_p256_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        scalars, xs, ys, ax, ay, z, B);
  }
  return (int)cudaGetLastError();
}

extern "C" int ec_window_p256_strict(const int32_t* scalars, const int32_t* xs,
                                     const int32_t* ys, int32_t* ax, int32_t* ay, int32_t* z,
                                     int64_t B, void* stream) {
  if (B > 0) {
    const int64_t blocks = (B + kThreads - 1) / kThreads;
    window_strict_p256_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        scalars, xs, ys, ax, ay, z, B);
  }
  return (int)cudaGetLastError();
}
