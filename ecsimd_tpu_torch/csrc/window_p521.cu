// Kernel E, the signed w = 4 window, plain and strict, on P-521 (NVIDIA
// Hopper, sm_90a): the C entry points of window.cuh's kernels over
// window_lane.cuh, which say what the kernel computes and how (32 threads a
// block, the table as dynamic shared memory). Replaces
// ecsimd_tpu/kernels/window.py:_window_kernel.

#include "coz_p521.cuh"
#include "window.cuh"

namespace p521 {
#include "window_lane.cuh"
}  // namespace p521

namespace {
constexpr int kThreadsP521 = 32;
EC_WINDOW_KERNEL_WIDE(window_p521_kernel, p521, false, kThreadsP521)
EC_WINDOW_KERNEL_WIDE(window_strict_p521_kernel, p521, true, kThreadsP521)
}  // namespace

// scalars: (33, B) int32 classical digit planes; xs, ys: the affine
// coordinates (z = 1), residues as stored; ax, ay, z: Jacobian outputs, all
// of that shape. Launch on `stream`; return cudaGetLastError().
extern "C" int ec_window_p521(const int32_t* scalars, const int32_t* xs, const int32_t* ys,
                              int32_t* ax, int32_t* ay, int32_t* z, int64_t B, void* stream) {
  return launch_wide<17, kThreadsP521>(window_p521_kernel, scalars, xs, ys, ax, ay, z, B,
                                     stream);
}

extern "C" int ec_window_p521_strict(const int32_t* scalars, const int32_t* xs,
                                     const int32_t* ys, int32_t* ax, int32_t* ay, int32_t* z,
                                     int64_t B, void* stream) {
  return launch_wide<17, kThreadsP521>(window_strict_p521_kernel, scalars, xs, ys, ax, ay,
                                     z, B, stream);
}

extern "C" int ec_window_p521_smem(void) { return smem_granted(window_p521_kernel); }
extern "C" int ec_window_p521_strict_smem(void) {
  return smem_granted(window_strict_p521_kernel);
}
