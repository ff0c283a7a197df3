// Kernel E, the signed w = 4 window, plain and strict, on P-384 (NVIDIA
// Hopper, sm_90a): the C entry points of window.cuh's kernels over
// window_lane.cuh, which say what the kernel computes and how (64 threads a
// block, four blocks an SM, the table split between shared memory and the
// scratch). The split: entries 0 .. 5 in shared memory (54 KiB a block, 864 bytes a thread), 6 and 7 in the
// scratch (288 bytes a slot). Replaces
// ecsimd_tpu/kernels/window.py:_window_kernel.

#include "coz_p384.cuh"
#include "window.cuh"

namespace p384 {
#include "window_lane.cuh"
}  // namespace p384

namespace {
constexpr int kOnChipP384 = 6;  // table entries in shared memory
using TableP384 = wtable::Split<p384::kWords, kOnChipP384>;
EC_WINDOW_KERNEL_WIDE(window_p384_kernel, p384, false, TableP384)
EC_WINDOW_KERNEL_WIDE(window_strict_p384_kernel, p384, true, TableP384)
int occupancy_p384 = 0, occupancy_strict_p384 = 0;
}  // namespace

// scalars: (24, B) int32 classical digit planes; xs, ys: the affine
// coordinates (z = 1), residues as stored (canonical); ax, ay, z: Jacobian
// outputs, all of that shape; scratch: TableP384::kScratchRows x slots
// 16-byte vectors, slots a multiple of 64 (kernels/window.py allocates it
// for SMs x `_occupancy` blocks of 64 threads). Launch on `stream`; return
// cudaGetLastError().
extern "C" int ec_window_p384(const int32_t* scalars, const int32_t* xs, const int32_t* ys,
                              int32_t* ax, int32_t* ay, int32_t* z, int32_t* scratch, int64_t B,
                              int64_t slots, void* stream) {
  return launch_split<TableP384>(window_p384_kernel, scalars, xs, ys, ax, ay, z, scratch, B,
                                slots, stream);
}

extern "C" int ec_window_p384_strict(const int32_t* scalars, const int32_t* xs,
                                     const int32_t* ys, int32_t* ax, int32_t* ay, int32_t* z,
                                     int32_t* scratch, int64_t B, int64_t slots,
                                     void* stream) {
  return launch_split<TableP384>(window_strict_p384_kernel, scalars, xs, ys, ax, ay, z,
                                scratch, B, slots, stream);
}

extern "C" int ec_window_p384_smem(void) { return smem_granted(window_p384_kernel); }
extern "C" int ec_window_p384_strict_smem(void) {
  return smem_granted(window_strict_p384_kernel);
}

// The blocks an SM the runtime grants each kernel at 64 threads and its
// table's shared memory, or minus the CUDA error.
extern "C" int ec_window_p384_occupancy(void) {
  return occupancy<TableP384>(window_p384_kernel, occupancy_p384);
}
extern "C" int ec_window_p384_strict_occupancy(void) {
  return occupancy<TableP384>(window_strict_p384_kernel, occupancy_strict_p384);
}
