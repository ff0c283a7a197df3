// Kernel E, the signed w = 4 window, plain and strict, on P-521 (NVIDIA
// Hopper, sm_90a): the C entry points of window.cuh's kernels over
// window_lane.cuh, which say what the kernel computes and how (64 threads a
// block, four blocks an SM, the table split between shared memory and the
// scratch). The split: entries 0 .. 3 and the eight entries' packed top words in
// shared memory (50 KiB a block, 800 bytes a thread), the whole words of
// entries 4 .. 7 in the scratch (768 bytes a slot). Replaces
// ecsimd_tpu/kernels/window.py:_window_kernel.

#include "coz_p521.cuh"
#include "window.cuh"

namespace p521 {
#include "window_lane.cuh"
}  // namespace p521

namespace {
constexpr int kOnChipP521 = 4;  // table entries in shared memory
using TableP521 = wtable::Split<p521::kWords, kOnChipP521>;
EC_WINDOW_KERNEL_WIDE(window_p521_kernel, p521, false, TableP521)
EC_WINDOW_KERNEL_WIDE(window_strict_p521_kernel, p521, true, TableP521)
int occupancy_p521 = 0, occupancy_strict_p521 = 0;
}  // namespace

// scalars: (33, B) int32 classical digit planes; xs, ys: the affine
// coordinates (z = 1), residues as stored (canonical); ax, ay, z: Jacobian
// outputs, all of that shape; scratch: TableP521::kScratchRows x slots
// 16-byte vectors, slots a multiple of 64 (kernels/window.py allocates it
// for SMs x `_occupancy` blocks of 64 threads). Launch on `stream`; return
// cudaGetLastError().
extern "C" int ec_window_p521(const int32_t* scalars, const int32_t* xs, const int32_t* ys,
                              int32_t* ax, int32_t* ay, int32_t* z, int32_t* scratch, int64_t B,
                              int64_t slots, void* stream) {
  return launch_split<TableP521>(window_p521_kernel, scalars, xs, ys, ax, ay, z, scratch, B,
                                slots, stream);
}

extern "C" int ec_window_p521_strict(const int32_t* scalars, const int32_t* xs,
                                     const int32_t* ys, int32_t* ax, int32_t* ay, int32_t* z,
                                     int32_t* scratch, int64_t B, int64_t slots,
                                     void* stream) {
  return launch_split<TableP521>(window_strict_p521_kernel, scalars, xs, ys, ax, ay, z,
                                scratch, B, slots, stream);
}

extern "C" int ec_window_p521_smem(void) { return smem_granted(window_p521_kernel); }
extern "C" int ec_window_p521_strict_smem(void) {
  return smem_granted(window_strict_p521_kernel);
}

// The blocks an SM the runtime grants each kernel at 64 threads and its
// table's shared memory, or minus the CUDA error.
extern "C" int ec_window_p521_occupancy(void) {
  return occupancy<TableP521>(window_p521_kernel, occupancy_p521);
}
extern "C" int ec_window_p521_strict_occupancy(void) {
  return occupancy<TableP521>(window_strict_p521_kernel, occupancy_strict_p521);
}
