// The query of the dynamic shared memory a kernel was given (host code),
// shared by the launchers that raise it above 48 KiB: kernels J's and L's
// (comb_tree.cu, comb_chains.cuh) and the P-384 / P-521 kernels B and E
// (comb_wide.cuh, window.cuh). Each source exports it per kernel as an
// `<entry>_smem` C function, which chip_smoke.py reads into its kernels line.

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

}  // namespace
