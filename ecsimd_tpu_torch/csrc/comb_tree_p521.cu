// Kernel J: the fixed-base comb summed by the JAX package's stride tree on
// P-521, one lane per thread (NVIDIA Hopper, sm_90a): comb_tree_wide_lane.cuh's
// walk of the 33 level-1 pairs over the P-521 field (field_p521.cuh, 17
// 32-bit words), launched by comb_tree_wide.cuh (87 KiB of dynamic shared
// memory, 128 threads a block), which says what the kernel computes, how it
// stays constant-time and what bounds it. Its Jacobian planes equal
// kernels/comb.comb_tree_plain's bit for bit. One source a curve, so that the
// builds run side by side. Replaces
// ecsimd_tpu/kernels/comb.py:_comb_kernel_tree (chain="tree").

#include "coz_p521.cuh"
#include "comb_tree_wide.cuh"

namespace p521 {
#include "comb_lane.cuh"
#include "comb_mma_lane.cuh"
#include "comb_tree_wide_lane.cuh"
}  // namespace p521

namespace {
EC_COMB_TREE_WIDE_KERNEL(comb_tree_p521_kernel, p521)
}  // namespace

// scalars: (33, B) int32 digit planes; tables: 8576 x 136 bytes
// (kernels/comb.mma_layout), 16-byte aligned; negbase: 66 int32 digits (x
// then y) of -B; ax, ay, z: (33, B) outputs. Launches on `stream` and returns
// cudaGetLastError(); <entry>_smem returns the dynamic shared memory a
// block is given (smem_granted), <entry>_blocks the blocks an SM holds
// (blocks_granted).
extern "C" int ec_comb_tree_p521(const int32_t* scalars, const uint8_t* tables,
                                 const int32_t* negbase, int32_t* ax, int32_t* ay, int32_t* z,
                                 int64_t B, void* stream) {
  return launch_tree_wide<p521::kWords>(comb_tree_p521_kernel, scalars, tables, negbase, ax, ay,
                                        z, B, stream);
}

extern "C" int ec_comb_tree_p521_smem(void) { return smem_granted(comb_tree_p521_kernel); }
extern "C" int ec_comb_tree_p521_blocks(void) {
  return blocks_granted(comb_tree_p521_kernel, kThreads);
}
