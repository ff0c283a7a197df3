// Kernel F: GLV double-scalar signed window k_i * P_i on secp256k1, one lane
// per thread (NVIDIA Hopper, sm_90a), plain and strict.
//
// Replaces ecsimd_tpu/kernels/glv.py:_glv_kernel (core _glv_core), both
// strict variants. k = s1 |k1| + s2 |k2| lambda (mod n) arrives split on the
// host side (kernels/glv.pack_scalars): rows 0..8 hold |k1|'s base-2^16
// digits, rows 9..17 |k2|'s, row 18 the sign of k1 and row 19 the sign of
// k2. phi(x, y, z) = (beta x, y, z) is lambda times the point, so
// k P = s1 |k1| P + s2 |k2| phi(P) with ~128-bit halves. Same formula
// sequence as kernels/glv.glv_plain, on Montgomery-form planes:
//   - the lane's table T[t] = (2t+1) P, t < 8 (one jac_dbl, seven jac_add);
//     phi(T[t]) = (beta T[t].x, T[t].y, T[t].z);
//   - acc = s1 P + s2 phi(P) (one add);
//   - 9 digits x 4 windows, MSB first: four jac_dbl, then acc += +-T[i1]
//     and acc += +-phi(T[i2]), each window recoded to the odd digit
//     ((w5 | 1) - 16) and its sign XORed with the half-scalar's sign;
//   - two parity fix-ups: where |k1| (|k2|) is even, acc += -s1 P
//     (-s2 phi(P)), since each half was computed as |k_i| | 1.
// Every add is jac_add (fix-ups add_z2_1), or add_complete when strict. The
// strict chain is total on [1, n): k = lambda gives k1 = 0 and lambda +- 1
// make the chain hit a table entry, and the complete adds resolve both.
// Output: Jacobian (X, Y, Z) planes in Montgomery form, bit-identical to
// the plain PyTorch version (every field result is canonical).
//
// Constant time per lane: both lookups read all eight entries and keep one
// with masks, the signs are masked negations, and the strict add computes
// both its add and its doubling; nothing is indexed or branched on by the
// secret scalar.
//
// The per-lane table is kernel E's (window_table.cuh): 768 bytes in shared
// memory, read with 16-byte loads, 48 KiB for a block of 64 threads, four
// blocks per SM. phi's x is formed after the lookup (one field multiply by
// beta per window, beta read from device memory where it is used) instead
// of kept in a second table: that would add 256 bytes a lane and push the
// block to 64 KiB. The two lookup-and-adds of a window are one rolled loop,
// so that the second lookup is not scheduled beside the first add: under
// __launch_bounds__(64, 4) the plain chain then fits the register file and
// the strict one spills a few words, in the parity fix-ups after the loops
// only (ptxas -v in phase 1 of chip_smoke.py).
//
// What bounds it: the integer pipes. A lane issues about 0.62 million
// instructions (0.77 million strict), 55 % on the ALU pipe and 44 % on the
// multiply-add pipe (bench/sass.py): the secp256k1 layer's sparse
// reduction (field_secp256k1.cuh) leaves the products a larger share than
// on P-256. 72 lookups a lane are 3,456 16-byte shared loads; device memory
// is 68 words a lane. Tensor cores and TMA do not apply (lane-specific
// operands, no stream of data to copy).

#include "coz_secp256k1.cuh"
#include "window_table.cuh"

namespace secp256k1 {

constexpr int kDigits = 9;  // digits of |k1| and |k2| (glv_params(SECP256K1).dk)

using wtable::Table;

// Signed-odd digit of the 4-bit window at bit `off` of a 16-bit digit
// (`next` is the digit above it): table index (|d| - 1) / 2 and sign.
__device__ __forceinline__ void recode(uint32_t digit, uint32_t next, int off, uint32_t& idx,
                                       uint32_t& neg) {
  uint32_t w = digit >> off;
  if (off) w |= next << (16 - off);
  const uint32_t v = (w & 31u) | 1u;  // digit v - 16, odd
  neg = (v >> 4) ^ 1u;                // v < 16
  const uint32_t m = 0u - neg;
  const uint32_t mag = ((v - 16u) ^ m) - m;  // |v - 16|, branch-free
  idx = (mag - 1u) >> 1;
}

template <bool kStrict>
__device__ __forceinline__ void glv_add(fe x1, fe y1, fe z1, fe x2, fe y2, fe z2, fe& x3,
                                        fe& y3, fe& z3) {
  if constexpr (kStrict) {
    add_complete(x1, y1, z1, x2, y2, z2, x3, y3, z3);
  } else {
    fe h, r;
    jac_add(x1, y1, z1, x2, y2, z2, x3, y3, z3, h, r);
  }
}

// beta (Montgomery form) from its 16 base-2^16 digits in device memory,
// read where it is used: the loads are volatile, so the compiler does not
// hoist them and keep beta in 8 registers across the loop.
__device__ __forceinline__ fe load_beta(const int32_t* digits) {
  uint32_t d[16];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    asm volatile("ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(d[4 * q]), "=r"(d[4 * q + 1]), "=r"(d[4 * q + 2]), "=r"(d[4 * q + 3])
                 : "l"(digits + 4 * q));
  }
  fe r;
#pragma unroll
  for (int j = 0; j < 8; ++j) r.v[j] = (d[2 * j] & 0xFFFFu) | (d[2 * j + 1] << 16);
  return r;
}

template <bool kStrict>
__device__ __forceinline__ void glv_lane(const int32_t* packed, const int32_t* xs,
                                         const int32_t* ys, const int32_t* beta_digits,
                                         int32_t* ax_out, int32_t* ay_out, int32_t* z_out,
                                         int64_t B, int64_t i, Table& tbl) {
  const uint32_t neg1 = (uint32_t)packed[(2 * kDigits) * B + i] & 1u;
  const uint32_t neg2 = (uint32_t)packed[(2 * kDigits + 1) * B + i] & 1u;

  fe accx, accy, accz;
  {
    // table of odd multiples: T[0] = P, T[t] = T[t-1] + 2P
    const fe one = fe_one();
    const fe x = fe_load(xs, B, i);
    const fe y = fe_load(ys, B, i);
    fe dx, dy, dz, tx = x, ty = y, tz = one;
    jac_dbl(x, y, one, dx, dy, dz);
    wtable::put(tbl, 0, tx, ty, tz);
#pragma unroll 1
    for (int t = 1; t < wtable::kEntries; ++t) {
      fe h, r;
      jac_add(tx, ty, tz, dx, dy, dz, tx, ty, tz, h, r);
      wtable::put(tbl, t, tx, ty, tz);
    }
    // acc = s1 P + s2 phi(P)
    const fe opp_y = fe_neg(y);
    glv_add<kStrict>(x, fe_select(neg1, opp_y, y), one, fe_mul(load_beta(beta_digits), x),
                     fe_select(neg2, opp_y, y), one, accx, accy, accz);
  }

#pragma unroll 1
  for (int dig = kDigits - 1; dig >= 0; --dig) {
    const uint32_t p1 = (uint32_t)packed[dig * B + i];
    const uint32_t p2 = (uint32_t)packed[(kDigits + dig) * B + i];
    const uint32_t p1n = dig + 1 < kDigits ? (uint32_t)packed[(dig + 1) * B + i] : 0u;
    const uint32_t p2n = dig + 1 < kDigits ? (uint32_t)packed[(kDigits + dig + 1) * B + i] : 0u;
#pragma unroll 1
    for (int off = 12; off >= 0; off -= 4) {
#pragma unroll 1
      for (int s = 0; s < 4; ++s) jac_dbl(accx, accy, accz, accx, accy, accz);
      // +-T[i1], then +-phi(T[i2]): one recoding, lookup and add an
      // iteration, so that the second lookup is not scheduled beside the
      // first add (two entries and an add's temporaries do not fit in 255
      // registers). The branches are on the loop counter, never on the
      // scalar.
#pragma unroll 1
      for (int half = 0; half < 2; ++half) {
        uint32_t idx, sgn;
        recode(half ? p2 : p1, half ? p2n : p1n, off, idx, sgn);
        fe ex, ey, ez;
        wtable::get(tbl, idx, ex, ey, ez);
        if (half) ex = fe_mul(load_beta(beta_digits), ex);
        ey = fe_select(sgn ^ (half ? neg2 : neg1), fe_neg(ey), ey);
        glv_add<kStrict>(accx, accy, accz, ex, ey, ez, accx, accy, accz);
      }
    }
  }

  // parity fix-ups: an even |k_i| was computed as |k_i| + 1; add -s_i base_i.
  // P and phi(P) are formed again here rather than kept live across the loop.
  const fe one = fe_one();
  const fe x = fe_load(xs, B, i);
  const fe y = fe_load(ys, B, i);
  const fe opp_y = fe_neg(y);
  const fe x2 = fe_mul(load_beta(beta_digits), x);
#pragma unroll 1
  for (int half = 0; half < 2; ++half) {
    const fe bx = half ? x2 : x;
    const uint32_t negm = half ? neg2 : neg1;
    const fe fy = fe_select(negm, y, opp_y);
    fe sx, sy, sz;
    if constexpr (kStrict) {
      add_complete(accx, accy, accz, bx, fy, one, sx, sy, sz);
    } else {
      add_z2_1(accx, accy, accz, bx, fy, sx, sy, sz);
    }
    const uint32_t even = ((uint32_t)packed[(half * kDigits) * B + i] & 1u) ^ 1u;
    accx = fe_select(even, sx, accx);
    accy = fe_select(even, sy, accy);
    accz = fe_select(even, sz, accz);
  }
  fe_store(ax_out, B, i, accx);
  fe_store(ay_out, B, i, accy);
  fe_store(z_out, B, i, accz);
}

}  // namespace secp256k1

namespace {

using wtable::kThreads;

// No barrier is needed: each thread reads only its own table column. Four
// blocks of 64 threads an SM, as kernel E.
#define EC_GLV_KERNEL(NAME, STRICT)                                                         \
  __global__ void __launch_bounds__(kThreads, 4)                                            \
  NAME(const int32_t* __restrict__ packed, const int32_t* __restrict__ xs,                  \
       const int32_t* __restrict__ ys, const int32_t* __restrict__ beta,                    \
       int32_t* __restrict__ ax, int32_t* __restrict__ ay, int32_t* __restrict__ z,         \
       int64_t B) {                                                                         \
    __shared__ wtable::Table tbl;                                                           \
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;                       \
    if (i >= B) return;                                                                     \
    secp256k1::glv_lane<STRICT>(packed, xs, ys, beta, ax, ay, z, B, i, tbl);                \
  }

EC_GLV_KERNEL(glv_secp256k1_kernel, false)
EC_GLV_KERNEL(glv_strict_secp256k1_kernel, true)

template <class Kernel>
int launch(Kernel kernel, const int32_t* packed, const int32_t* xs, const int32_t* ys,
           const int32_t* beta, int32_t* ax, int32_t* ay, int32_t* z, int64_t B, void* stream) {
  if (B > 0) {
    const int64_t blocks = (B + kThreads - 1) / kThreads;
    kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(packed, xs, ys, beta, ax,
                                                                        ay, z, B);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// packed: (20, B) int32 rows from kernels/glv.pack_scalars; xs, ys: (16, B)
// int32 Montgomery-form digit planes of an affine point (z = 1); beta: 16
// int32 Montgomery-form digits of beta; ax, ay, z: (16, B) Jacobian outputs.
// Launch on `stream`; return cudaGetLastError().
extern "C" int ec_glv_secp256k1(const int32_t* packed, const int32_t* xs, const int32_t* ys,
                                const int32_t* beta, int32_t* ax, int32_t* ay, int32_t* z,
                                int64_t B, void* stream) {
  return launch(glv_secp256k1_kernel, packed, xs, ys, beta, ax, ay, z, B, stream);
}

extern "C" int ec_glv_secp256k1_strict(const int32_t* packed, const int32_t* xs,
                                       const int32_t* ys, const int32_t* beta, int32_t* ax,
                                       int32_t* ay, int32_t* z, int64_t B, void* stream) {
  return launch(glv_strict_secp256k1_kernel, packed, xs, ys, beta, ax, ay, z, B, stream);
}
