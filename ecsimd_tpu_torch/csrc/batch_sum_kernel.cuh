// Kernel M's kernel and launcher: the whole batch reduction tree of
// multi-scalar multiplication, or its first `levels` levels, in one
// cooperative launch (NVIDIA Hopper, sm_90a). batch_sum.cu (P-256,
// secp256k1, Wei25519), batch_sum_p384.cu and batch_sum_p521.cu include this
// file first, then batch_sum_lane.cuh inside each curve's namespace (its
// batch_sum_tree walks the levels), and instantiate EC_BATCH_SUM_KERNEL
// once a curve beside its extern "C" launcher and queries.
//
// The grid is as many blocks as the card holds at once (the occupancy
// query times the SMs, fewer where the first level needs fewer), so that
// cooperative_groups' grid sync may separate the levels; cudaLaunchCooperativeKernel
// refuses a grid that is not co-resident, and the launcher returns that
// error: there is no per-level fallback.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace batch_sum {

// Threads a block on every curve, and __launch_bounds__(kThreads, 1): 64
// and 256 threads and (128, 3) measured no faster (PERF.md). A level whose
// output has at most kThreads lanes runs in block 0 alone.
constexpr int kThreads = 128;

// The blocks of kThreads threads an SM holds of `kernel`
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor, no dynamic shared
// memory), queried once into `cached`; minus the CUDA error if the query
// fails.
template <class Kernel>
int blocks_per_sm(Kernel kernel, int& cached) {
  if (cached > 0) return cached;
  int blocks = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                                        kThreads, 0);
  if (err != cudaSuccess) return -(int)err;
  cached = blocks;
  return blocks;
}

// xs, ys, zs: (D, n) Jacobian planes in the field's internal form, n >= 2;
// ox, oy, oz: the planes left after `levels` levels (1 <= levels <=
// ceil(log2 n); (D, 1) for the whole tree); scratch: the two ping-pong
// buffers of batch_sum_tree, 3 D (h0 + ceil(h0 / 2)) words, h0 = ceil(n / 2)
// (unused for levels = 1). Launches on `stream` and returns the CUDA error
// of the launch (cudaErrorCooperativeLaunchTooLarge where the card holds no
// block, cudaErrorNotSupported without cooperative launches).
template <class Kernel>
int launch(Kernel kernel, int& cached, const int32_t* xs, const int32_t* ys,
           const int32_t* zs, int32_t* ox, int32_t* oy, int32_t* oz, int32_t* scratch,
           int64_t n, int64_t levels, void* stream) {
  if (n < 2 || levels < 1) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, coop = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return (int)err;
  if (!coop) return (int)cudaErrorNotSupported;
  const int per_sm = blocks_per_sm(kernel, cached);
  if (per_sm < 0) return -per_sm;
  if (per_sm == 0) return (int)cudaErrorCooperativeLaunchTooLarge;
  const int64_t need = (n - n / 2 + kThreads - 1) / kThreads;  // the first level's blocks
  const int64_t resident = (int64_t)per_sm * sms;
  const unsigned blocks = (unsigned)(need < resident ? need : resident);
  void* args[] = {(void*)&xs, (void*)&ys, (void*)&zs, (void*)&ox, (void*)&oy,
                  (void*)&oz, (void*)&scratch, (void*)&n, (void*)&levels};
  err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(blocks), dim3(kThreads), args, 0,
                                    (cudaStream_t)stream);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

}  // namespace batch_sum

// A curve's kernel over NS::batch_sum_tree, batch_sum_TAG_kernel, with the
// cache of its blocks an SM, blocks_TAG, for the source's extern "C"
// entries. SHARED_TAIL: block 0 keeps its levels in shared memory (true) or
// in the L2-resident scratch (false), chosen a curve by measurement
// (batch_sum_lane.cuh). No pointer is __restrict__: a level reads what the
// one before it wrote in the same launch, which the read-only path would
// not see.
#define EC_BATCH_SUM_KERNEL(TAG, NS, SHARED_TAIL)                                           \
  namespace {                                                                               \
  int blocks_##TAG = 0;                                                                     \
  __global__ void __launch_bounds__(batch_sum::kThreads, 1)                                 \
  batch_sum_##TAG##_kernel(const int32_t* xs, const int32_t* ys, const int32_t* zs,         \
                           int32_t* ox, int32_t* oy, int32_t* oz, int32_t* scratch,         \
                           int64_t n, int64_t levels) {                                     \
    NS::batch_sum_tree<SHARED_TAIL>(xs, ys, zs, ox, oy, oz, scratch, n, levels);            \
  }                                                                                         \
  }
