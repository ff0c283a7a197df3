// The queries of the dynamic shared memory a kernel was given and the
// blocks an SM it holds (host code), for the kernels launched with dynamic
// shared memory: B, J, K and L (comb*.cu) and the P-384 / P-521 kernel E
// (window_<tag>.cu), and the blocks of kernel G (mladder.cu). Each source
// exports them per kernel as C functions, `<entry>_smem` and (the comb's
// and G's) `<entry>_blocks`, which chip_smoke.py reads into its kernels
// line.

#pragma once

#include <cuda_runtime.h>

namespace {

// The dynamic shared memory the runtime gives a block of `kernel`, as its
// launcher set it (cudaFuncAttributes::maxDynamicSharedSizeBytes), or minus
// the CUDA error if the query fails.
template <class Kernel>
int smem_granted(Kernel kernel) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  return err == cudaSuccess ? attr.maxDynamicSharedSizeBytes : -(int)err;
}

// The blocks of `threads` threads an SM holds of `kernel` at the dynamic
// shared memory its launcher set (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
// or minus the CUDA error if a query fails.
template <class Kernel>
int blocks_granted(Kernel kernel, int threads) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  int blocks = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads,
                                                        attr.maxDynamicSharedSizeBytes);
  }
  return err == cudaSuccess ? blocks : -(int)err;
}

}  // namespace
