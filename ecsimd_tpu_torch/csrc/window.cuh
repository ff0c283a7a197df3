// Kernel E: signed fixed-window (w = 4) k_i * P_i, one lane per thread
// (NVIDIA Hopper, sm_90a), plain and strict: the kernels and their launcher
// over the lane of window_lane.cuh. The instantiations are split over one
// source per curve so that their builds run side by side: window.cu
// (P-256), window_secp256k1.cu, window_w25519.cu, window_p384.cu and
// window_p521.cu.
//
// Replaces ecsimd_tpu/kernels/window.py:_window_kernel (core _window_core),
// both strict variants, which the JAX package runs on every curve. Same
// formula sequence as kernels/window.window_plain: the lane builds its
// table T[t] = (2t+1) P, t < 8 (one jac_dbl, the curve's own doubling, and
// seven jac_add); the accumulator starts at P (the recoding's top digit is
// 1); then for each 4-bit window, MSB first (bit offsets 252 .. 0): four
// jac_dbl and one add of +-T[idx] — jac_add, or add_complete when strict.
// Window i reads bits 4i .. 4i+4 of k (bit nbits reads as 0) and recodes
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
// P-384 and P-521 (12- and 17-word elements): the table of a thread is
// 1,152 or 1,920 bytes (window_table.cuh), so a block takes it as dynamic
// shared memory, raised above 48 KiB at launch: 64 threads a block on
// P-384 (72 KiB, three blocks an SM), 32 on P-521 (60 KiB, three blocks an
// SM). The SM's 227 KiB hold no more than 192 and 96 such threads however
// they are grouped; smaller blocks keep the 128 KiB a 64-thread P-521 block
// would take from leaving one block an SM. Their field multiplies are
// calls, not inlined (field_p384.cuh).
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
#include "smem.cuh"

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

// --- P-384 and P-521: the table as dynamic shared memory ---------------------

// The table of a block of T threads at N words, in bytes.
template <int N, int T>
constexpr int table_bytes() {
  return wtable::kEntries * wtable::vecs<N>() * T * (int)sizeof(uint4);
}

#define EC_WINDOW_KERNEL_WIDE(NAME, NS, STRICT, THREADS)                                  \
  __global__ void __launch_bounds__(THREADS)                                               \
  NAME(const int32_t* __restrict__ scalars, const int32_t* __restrict__ xs,                \
       const int32_t* __restrict__ ys, int32_t* __restrict__ ax, int32_t* __restrict__ ay,  \
       int32_t* __restrict__ z, int64_t B) {                                               \
    extern __shared__ uint4 smem[];                                                        \
    using Table = uint4[wtable::kEntries * wtable::vecs<NS::kWords>()][THREADS];           \
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;                      \
    if (i >= B) return;                                                                    \
    NS::window_lane<STRICT>(scalars, xs, ys, ax, ay, z, B, i,                              \
                            *reinterpret_cast<Table*>(smem));                              \
  }

// Launch a wide instantiation with T threads a block and its table as
// dynamic shared memory; return cudaGetLastError() (or the attribute's
// error).
template <int N, int T, class Kernel>
int launch_wide(Kernel kernel, const int32_t* scalars, const int32_t* xs, const int32_t* ys,
                int32_t* ax, int32_t* ay, int32_t* z, int64_t B, void* stream) {
  if (B > 0) {
    constexpr int bytes = table_bytes<N, T>();
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    const int64_t blocks = (B + T - 1) / T;
    kernel<<<(unsigned)blocks, T, bytes, (cudaStream_t)stream>>>(scalars, xs, ys, ax, ay, z, B);
  }
  return (int)cudaGetLastError();
}


}  // namespace
