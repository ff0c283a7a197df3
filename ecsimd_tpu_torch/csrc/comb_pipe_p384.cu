// Kernel K: the fixed-base comb's serial chain, software-pipelined, on
// P-384, one lane per thread (NVIDIA Hopper, sm_90a): comb_pipe_lane.cuh's
// chain over the P-384 field (12 32-bit words, field_p384.cuh),
// launched by comb_mma.cuh in kernel B's shape (38 KiB of dynamic shared
// memory, 128 threads a block). comb_pipe.cu says what the kernel computes,
// how it stays constant-time and what bounds it; here the chain has 48
// positions, an entry is 96 bytes (the x then the y limbs, 12 n-tiles of
// the product), position 0 is 24 KiB and each other 12 KiB, and the pipeline
// holds one more entry (24 words) in registers than the serial chain.
// Its value is kernel B's, bit for bit. One source a curve, so that the
// builds run side by side. Replaces
// ecsimd_tpu/kernels/comb.py:_comb_kernel_pipe (chain="pipe").

#include "coz_p384.cuh"
#include "comb_mma.cuh"

namespace p384 {
#include "comb_lane.cuh"
#include "comb_mma_lane.cuh"
#include "comb_pipe_lane.cuh"
}  // namespace p384

namespace {
EC_COMB_PIPE_KERNEL(comb_pipe_p384_kernel, p384)
}  // namespace

// scalars: (24, B) int32 digit planes; tables: 6272 x 96 bytes
// (kernels/comb.mma_layout), 16-byte aligned; negbase: 48 int32 digits (x
// then y) of -B; ax, ay, z: (24, B) outputs. Launches on `stream` and returns
// cudaGetLastError(); <entry>_smem returns the dynamic shared memory a
// block is given (smem_granted), <entry>_blocks the blocks an SM holds
// (blocks_granted).
extern "C" int ec_comb_pipe_p384(const int32_t* scalars, const uint8_t* tables,
                                 const int32_t* negbase, int32_t* ax, int32_t* ay, int32_t* z,
                                 int64_t B, void* stream) {
  return launch_serial<p384::kWords>(comb_pipe_p384_kernel, scalars, tables, negbase, ax, ay,
                                     z, B, stream);
}

extern "C" int ec_comb_pipe_p384_smem(void) { return smem_granted(comb_pipe_p384_kernel); }
extern "C" int ec_comb_pipe_p384_blocks(void) {
  return blocks_granted(comb_pipe_p384_kernel, comb::kThreads);
}
