// Kernel E: signed fixed-window (w = 4) k_i * P_i, one lane per thread
// (NVIDIA Hopper, sm_90a), plain and strict: the kernels and their launcher
// over the lane of window_lane.cuh. The instantiations are split over one
// source per curve so that their builds run side by side: window.cu
// (P-256), window_secp256k1.cu and window_w25519.cu.
//
// Replaces ecsimd_tpu/kernels/window.py:_window_kernel (core _window_core),
// both strict variants, which the JAX package runs on every curve. Same
// formula sequence as kernels/window.window_plain: the lane builds its
// table T[t] = (2t+1) P, t < 8 (one jac_dbl, the curve's own doubling, and
// seven jac_add); the accumulator starts at P (the recoding's top digit is
// 1); then for each 4-bit window, MSB first (bit offsets 252 .. 0): four
// jac_dbl and one add of +-T[idx] — jac_add, or add_complete when strict.
// Window i reads bits 4i .. 4i+4 of k (bit 256 reads as 0) and recodes
// them to the odd digit ((w5 | 1) - 16). Even scalars then add -P
// (add_z2_1, or add_complete when strict), since k was computed as k | 1.
// Output: Jacobian (X, Y, Z) planes, bit-identical to the plain PyTorch
// version (every field result is canonical), in the field's internal form
// (Montgomery form on secp256k1).
//
// Constant time per lane: the lookup reads all eight entries and keeps one
// with masks, the digit's sign is a masked negation, and the strict add
// computes both its add and its doubling; nothing is indexed or branched on
// by the secret scalar.
//
// The per-lane table (768 bytes) lives in shared memory and is read with
// 16-byte loads (window_table.cuh): 48 KiB for a block of 64 threads, four
// blocks per SM; __launch_bounds__(64, 4) holds the registers to that
// occupancy (ptxas -v in phase 1 of chip_smoke.py reports each
// instantiation's registers and spills).
//
// What bounds it: the integer ALU pipe. A P-256 lane issues about 0.86
// million instructions (1.0 million strict), 73 % of them on the ALU pipe
// (carry chains, the Solinas reduction, selects) and 26 % on the
// multiply-add pipe (bench/sass.py); the 64 table lookups are 3,072 16-byte shared
// loads and the device memory 48 words a lane. The design: one multiply
// core with a dedicated squaring (mul256.cuh), the reduction and the
// modular adds on 32-bit carry chains, the 16-byte table scan, and a live
// set that fits the register file. The tensor cores and TMA do not apply
// (lane-specific operands, no stream of data to copy).

#pragma once

#include "window_table.cuh"

namespace {

using wtable::kThreads;

// No barrier is needed: each thread reads only its own table column. Four
// blocks of 64 threads an SM: the tables' 4 x 48 KiB of shared memory and
// the register file (255 a thread) both allow no more.
#define EC_WINDOW_KERNEL(NAME, NS, STRICT)                                                 \
  __global__ void __launch_bounds__(kThreads, 4)                                           \
  NAME(const int32_t* __restrict__ scalars, const int32_t* __restrict__ xs,                \
       const int32_t* __restrict__ ys, int32_t* __restrict__ ax, int32_t* __restrict__ ay,  \
       int32_t* __restrict__ z, int64_t B) {                                               \
    __shared__ wtable::Table tbl;                                                          \
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;                      \
    if (i >= B) return;                                                                    \
    NS::window_lane<STRICT>(scalars, xs, ys, ax, ay, z, B, i, tbl);                        \
  }

template <class Kernel>
int launch(Kernel kernel, const int32_t* scalars, const int32_t* xs, const int32_t* ys,
           int32_t* ax, int32_t* ay, int32_t* z, int64_t B, void* stream) {
  if (B > 0) {
    const int64_t blocks = (B + kThreads - 1) / kThreads;
    kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(scalars, xs, ys, ax, ay,
                                                                      z, B);
  }
  return (int)cudaGetLastError();
}

}  // namespace
