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
// P-384 and P-521 (12- and 17-word elements): a thread's table (1,152 or
// 1,568 bytes) does not fit the 908 bytes a thread that eight warps an SM
// leave in shared memory, and at fewer warps (three on P-521, six on
// P-384, when the whole table sat in shared memory) the SM's schedulers
// had nothing to hide latency with. So the table is split
// (window_table.cuh's Split, one constant K a curve, window_<tag>.cu):
// entries 0 .. K-1 (and P-521's packed top words) in dynamic shared
// memory, entries K .. 7 in a scratch in device memory that the wrapper
// allocates, [vector][slot], one column for each thread of a persistent
// grid of SMs x 4 blocks of 64 threads (window.py asks the source's
// `_occupancy` query for the blocks). The scratch, 26 MB on P-521 and
// 10 MB on P-384, stays in the 50 MB L2; a P-521 lookup reads 768 bytes
// a lane from it. __launch_bounds__(64, 4) holds the registers to 255.
// The scratch is read with 16-byte ld.global (the thread wrote it; never
// the read-only path: phase 1 of chip_smoke.py checks the SASS). It is a
// device buffer, not a thread-local array: a local array would be the
// same L2-backed memory, and was not tried. Constant time: the lookup
// still reads all eight entries, on chip and off, and keeps one with
// masks; every shared and global address depends on the entry number,
// the vector, the thread and the slot only, and the walk over the lanes
// on the batch, never on a scalar. The field multiplies are calls, not
// inlined (field_p384.cuh; inlined, the wide E ran as fast or up to 82 %
// slower, bench/occupancy.py --inline, PERF.md).
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

// --- P-384 and P-521: the table split between shared memory and a scratch ---

// Kernel E on a wide curve: 64 threads a block, four blocks an SM (eight
// warps; the register file allows 255 registers a thread at that), its
// TABLE (window_table.cuh's Split: the first K entries in dynamic shared
// memory, the rest in the scratch). A persistent grid: thread `slot` of
// the grid walks lanes slot, slot + slots, ... and reuses its own column
// of the scratch; lanes and slots are public, so no address or branch
// depends on a scalar.
#define EC_WINDOW_KERNEL_WIDE(NAME, NS, STRICT, TABLE)                                    \
  __global__ void __launch_bounds__(kThreads, 4)                                           \
  NAME(const int32_t* __restrict__ scalars, const int32_t* __restrict__ xs,                \
       const int32_t* __restrict__ ys, int32_t* __restrict__ ax, int32_t* __restrict__ ay,  \
       int32_t* __restrict__ z, int32_t* scratch, int64_t B, int64_t slots) {              \
    extern __shared__ uint4 smem[];                                                        \
    TABLE tbl{reinterpret_cast<uint4(*)[kThreads]>(smem), reinterpret_cast<uint4*>(scratch), \
              slots, (int64_t)blockIdx.x * kThreads + threadIdx.x};                         \
    for (int64_t i = tbl.slot; i < B; i += slots)                                          \
      NS::window_lane<STRICT>(scalars, xs, ys, ax, ay, z, B, i, tbl);                      \
  }

// Launch a wide instantiation over `slots` scratch columns (a multiple of
// kThreads: the wrapper's resident threads, SMs x blocks an SM x kThreads),
// at most one thread a lane; return cudaGetLastError() (or the
// attribute's error, or cudaErrorInvalidValue for a slot count the grid
// cannot take).
template <class Table, class Kernel>
int launch_split(Kernel kernel, const int32_t* scalars, const int32_t* xs, const int32_t* ys,
                 int32_t* ax, int32_t* ay, int32_t* z, int32_t* scratch, int64_t B,
                 int64_t slots, void* stream) {
  if (slots <= 0 || slots % kThreads != 0 || slots / kThreads > 0x7FFFFFFF)
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Table::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  if (B > 0) {
    const int64_t lanes_blocks = (B + kThreads - 1) / kThreads;
    const int64_t blocks = lanes_blocks < slots / kThreads ? lanes_blocks : slots / kThreads;
    kernel<<<(unsigned)blocks, kThreads, Table::kSmemBytes, (cudaStream_t)stream>>>(
        scalars, xs, ys, ax, ay, z, scratch, B, slots);
  }
  return (int)cudaGetLastError();
}

// The blocks of `kernel` an SM holds at kThreads threads and its table's
// shared memory (cudaOccupancyMaxActiveBlocksPerMultiprocessor), queried
// once into `cached`; minus the CUDA error if a query fails.
template <class Table, class Kernel>
int occupancy(Kernel kernel, int& cached) {
  if (cached > 0) return cached;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Table::kSmemBytes);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads,
                                                        Table::kSmemBytes);
  if (err != cudaSuccess) return -(int)err;
  cached = blocks;
  return blocks;
}

}  // namespace
