// Kernel B on P-384 and P-521 (sm_90a): the kernel template
// (EC_COMB_WIDE_KERNEL, two a namespace), its launcher and its
// dynamic-shared-memory query, for comb_p384.cu and comb_p521.cu. The lane
// is comb_lane.cuh's, included inside the field's namespace; comb.cu says
// what the kernel computes, how it stays constant-time and what bounds it.
//
// An entry is 2 Layout<N>::kCoordVecs 16-byte vectors (comb_scan.cuh), so
// the two staging buffers of the largest position (position 0, 256
// entries) take 48 KiB on P-384 and 80 KiB on P-521: dynamic shared
// memory, raised at launch, 128 threads a block (two blocks an SM at
// P-521's 255 registers a thread).

#pragma once

#include "comb_scan.cuh"
#include "smem.cuh"

namespace {

using comb::kThreads;

// The block's two staging buffers at N words a coordinate.
template <int N>
using Buffers = uint4[2][comb::Layout<N>::kBufVecs];

// Lanes past the end of the batch run the chain on the last lane and store
// nothing: every thread takes part in the block's staging and barriers.
#define EC_COMB_WIDE_KERNEL(NAME, NS, STRICT)                                              \
  __global__ void __launch_bounds__(kThreads)                                              \
  NAME(const int32_t* __restrict__ scalars, const uint4* __restrict__ tables,              \
       const int32_t* __restrict__ negbase, int32_t* __restrict__ ax,                      \
       int32_t* __restrict__ ay, int32_t* __restrict__ z, int64_t B) {                     \
    extern __shared__ uint4 smem[];                                                        \
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;                      \
    NS::comb_lane<STRICT>(scalars, tables, negbase, ax, ay, z, B, i < B ? i : B - 1,       \
                          i < B, *reinterpret_cast<Buffers<NS::kWords>*>(smem));           \
  }

// Launch `kernel` (N words a coordinate) on `stream` with its buffers as
// dynamic shared memory; return cudaGetLastError() (or the attribute's
// error).
template <int N, class Kernel>
int launch_wide(Kernel kernel, const int32_t* scalars, const int32_t* tables,
                const int32_t* negbase, int32_t* ax, int32_t* ay, int32_t* z, int64_t B,
                void* stream) {
  if (B > 0) {
    constexpr int bytes = (int)sizeof(Buffers<N>);
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    const int64_t blocks = (B + kThreads - 1) / kThreads;
    kernel<<<(unsigned)blocks, kThreads, bytes, (cudaStream_t)stream>>>(
        scalars, reinterpret_cast<const uint4*>(tables), negbase, ax, ay, z, B);
  }
  return (int)cudaGetLastError();
}


}  // namespace
