// Kernel A: the co-Z masked-swap ladder k_i * P_i on P-256, one lane per
// thread (NVIDIA Hopper, sm_90a).
//
// Replaces ecsimd_tpu/kernels/ladder.py:_ladder_kernel (core _ladder_core).
// Same formula sequence as curves/group.scalar_mult: TPLU seed (3P, P),
// swap on bit 1, then for bits 2..255 swap on the bit, ZDAU, swap again;
// finally ADD_Z2_1(acc, (x, -y)) selected on even lanes. Output: Jacobian
// (X, Y, Z) planes, bit-identical to the plain PyTorch version.
//
// What bounds it: 32-bit integer multiply-add throughput — 254 ZDAU steps
// of 16 field multiplies each, per lane, with nothing to read from memory in
// the loop. The design keeps the whole ladder state (two co-Z points and
// the shared Z, 40 words) in registers for all 254 steps and re-reads each
// 32-bit scalar word from global memory once per 32 bits, so the loop body
// is pure arithmetic; masked swaps keep control flow uniform across the
// warp (and constant-time per lane). Lanes past the end of the batch
// return at once (i < B), so the batch needs no padding.

#include "coz_p256.cuh"

namespace p256 {

__device__ __forceinline__ void ladder_lane(const int32_t* scalars, const int32_t* xs,
                                            const int32_t* ys, int32_t* ax_out,
                                            int32_t* ay_out, int32_t* z_out, int64_t B,
                                            int64_t i) {
  const fe x = fe_load(xs, B, i);
  const fe y = fe_load(ys, B, i);
  fe ax, ay, bx, by, z;
  tplu(x, y, bx, by, ax, ay, z);  // base = 3P, acc = P

  const uint32_t k0 = scalar_word(scalars, B, i, 0);
  const uint32_t m1 = (k0 >> 1) & 1u;
  fe_swap_if(m1, ax, bx);
  fe_swap_if(m1, ay, by);

  for (int w = 0; w < 8; ++w) {
    const uint32_t kw = scalar_word(scalars, B, i, w);
    for (int bit = (w == 0 ? 2 : 0); bit < 32; ++bit) {
      const uint32_t m = (kw >> bit) & 1u;
      fe_swap_if(m, ax, bx);
      fe_swap_if(m, ay, by);
      zdau(bx, by, ax, ay, z, bx, by, ax, ay, z);
      fe_swap_if(m, ax, bx);
      fe_swap_if(m, ay, by);
    }
  }

  // parity fixup: even scalars got (k+1)P; subtract P
  fe sx, sy, sz;
  add_z2_1(ax, ay, z, x, fe_neg(y), sx, sy, sz);
  const uint32_t even = (k0 & 1u) ^ 1u;
  fe_store(ax_out, B, i, fe_select(even, sx, ax));
  fe_store(ay_out, B, i, fe_select(even, sy, ay));
  fe_store(z_out, B, i, fe_select(even, sz, z));
}

}  // namespace p256

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
ladder_p256_kernel(const int32_t* __restrict__ scalars, const int32_t* __restrict__ xs,
                   const int32_t* __restrict__ ys, int32_t* __restrict__ ax,
                   int32_t* __restrict__ ay, int32_t* __restrict__ z, int64_t B) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  p256::ladder_lane(scalars, xs, ys, ax, ay, z, B, i);
}

}  // namespace

// scalars, xs, ys: (16, B) int32 digit planes; ax, ay, z: (16, B) outputs.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int ec_ladder_p256(const int32_t* scalars, const int32_t* xs, const int32_t* ys,
                              int32_t* ax, int32_t* ay, int32_t* z, int64_t B,
                              void* stream) {
  if (B > 0) {
    const int64_t blocks = (B + kThreads - 1) / kThreads;
    ladder_p256_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        scalars, xs, ys, ax, ay, z, B);
  }
  return (int)cudaGetLastError();
}
