// Kernel K: the fixed-base comb's serial chain, software-pipelined, on
// P-256, one lane per thread (NVIDIA Hopper, sm_90a).
//
// Replaces ecsimd_tpu/kernels/comb.py:_comb_kernel_pipe (chain="pipe"). The
// TPU kernel gathers entry j + 1 on its matrix unit (a one-hot product)
// while its vector unit adds entry j. Here the gather is kernel B's masked
// scan of a position staged in shared memory (shared-memory loads and
// masked ORs: the load/store and integer-logic pipes), and the add is the
// field arithmetic (the multiply-add pipe). So iteration j reads entry
// j + 1 out of its staged position into registers and adds entry j, read
// in the iteration before: the two have no data dependence, and the warp
// schedulers can issue one warp's scan beside another warp's multiplies.
// Position j + 2 is copied into shared memory meanwhile (cp.async, double
// buffered). The chain is kernel B's: the same entries in the same order
// through the same ADD_Z2_1, the same fix-up, so the Jacobian planes are
// bit-identical to kernel B non-strict and to kernels/comb.comb_plain.
//
// Constant time, memory accesses included: no address depends on the
// scalar. Every position is staged whole and every thread reads every
// entry of it with masks (comb_scan.cuh); which buffer and which position
// a step reads is set by the loop counter.
//
// What bounds it: as kernel B, the chain's 32-bit multiply-adds (31 + 1
// mixed adds of 7 M + 4 S) beside the masked scan (~68 K shared-memory
// words per lane); the pipeline holds one more entry (16 words) in
// registers than kernel B.

#include "coz_p256.cuh"
#include "comb_scan.cuh"

namespace p256 {
#include "comb_lane.cuh"

// One lane of the pipelined comb; every thread takes part in the block's
// staging and barriers, and only active lanes store.
__device__ __forceinline__ void comb_pipe_lane(const int32_t* scalars, const uint4* tables,
                                               const int32_t* negbase, int32_t* ax_out,
                                               int32_t* ay_out, int32_t* z_out, int64_t B,
                                               int64_t i, bool active,
                                               uint4 (*buf)[comb::kBufVecs]) {
  constexpr int kPos = comb::kPositions;
  fe x, y, z, ex, ey;
  // prologue: position 0 seeds the accumulator, position 1 is read ahead
  comb::stage_position(tables, 0, buf[0]);
  comb::stage_position(tables, 1, buf[1]);
  comb::wait_staged<1>();
  __syncthreads();
  read_entry(buf[0], 0, comb::entry_index(scalars, B, i, 0), x, y);
  z = fe_one();
  __syncthreads();
  comb::stage_position(tables, 2, buf[0]);
  comb::wait_staged<1>();
  __syncthreads();
  read_signed_entry(buf[1], comb::entry_index(scalars, B, i, 1), ex, ey);
  __syncthreads();
  // step j holds entry j in (ex, ey); position j + 1 is staged or in flight
  // in buf[(j + 1) & 1], and buf[j & 1] is free
#pragma unroll 1
  for (int j = 1; j < kPos; ++j) {
    fe nx = ex, ny = ey;
    if (j + 1 < kPos) {
      if (j + 2 < kPos) {
        comb::stage_position(tables, j + 2, buf[j & 1]);
        comb::wait_staged<1>();
      } else {
        comb::wait_staged<0>();
      }
      __syncthreads();
      read_signed_entry(buf[(j + 1) & 1], comb::entry_index(scalars, B, i, j + 1), nx, ny);
    }
    add_z2_1(x, y, z, ex, ey, x, y, z);
    __syncthreads();  // the next step stages into the buffer just read
    ex = nx;
    ey = ny;
  }
  comb_finish<false>(x, y, z, scalars, negbase, ax_out, ay_out, z_out, B, i, active);
}

}  // namespace p256

namespace {

using comb::kThreads;

// Lanes past the end of the batch run the chain on the last lane and store
// nothing: every thread takes part in the block's staging and barriers.
__global__ void __launch_bounds__(kThreads)
comb_pipe_p256_kernel(const int32_t* __restrict__ scalars, const uint4* __restrict__ tables,
                      const int32_t* __restrict__ negbase, int32_t* __restrict__ ax,
                      int32_t* __restrict__ ay, int32_t* __restrict__ z, int64_t B) {
  __shared__ uint4 buf[2][comb::kBufVecs];
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  p256::comb_pipe_lane(scalars, tables, negbase, ax, ay, z, B, i < B ? i : B - 1, i < B, buf);
}

}  // namespace

// scalars: (16, B) int32 digit planes; tables: (4224, 16) int32 limbs,
// 16-byte aligned; negbase: 32 int32 digits (x then y) of -B; ax, ay, z:
// (16, B) outputs. Launches on `stream` and returns cudaGetLastError().
extern "C" int ec_comb_pipe_p256(const int32_t* scalars, const int32_t* tables,
                                 const int32_t* negbase, int32_t* ax, int32_t* ay, int32_t* z,
                                 int64_t B, void* stream) {
  if (B > 0) {
    const int64_t blocks = (B + kThreads - 1) / kThreads;
    comb_pipe_p256_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        scalars, reinterpret_cast<const uint4*>(tables), negbase, ax, ay, z, B);
  }
  return (int)cudaGetLastError();
}
