// Kernel E, the signed w = 4 window, plain and strict, on P-384 (NVIDIA
// Hopper, sm_90a): the C entry points of window.cuh's kernels over
// window_lane.cuh, which say what the kernel computes and how (64 threads a
// block, the table as dynamic shared memory). Replaces
// ecsimd_tpu/kernels/window.py:_window_kernel.

#include "coz_p384.cuh"
#include "window.cuh"

namespace p384 {
#include "window_lane.cuh"
}  // namespace p384

namespace {
constexpr int kThreadsP384 = 64;
EC_WINDOW_KERNEL_WIDE(window_p384_kernel, p384, false, kThreadsP384)
EC_WINDOW_KERNEL_WIDE(window_strict_p384_kernel, p384, true, kThreadsP384)
}  // namespace

// scalars: (24, B) int32 classical digit planes; xs, ys: the affine
// coordinates (z = 1), residues as stored; ax, ay, z: Jacobian outputs, all
// of that shape. Launch on `stream`; return cudaGetLastError().
extern "C" int ec_window_p384(const int32_t* scalars, const int32_t* xs, const int32_t* ys,
                              int32_t* ax, int32_t* ay, int32_t* z, int64_t B, void* stream) {
  return launch_wide<12, kThreadsP384>(window_p384_kernel, scalars, xs, ys, ax, ay, z, B,
                                     stream);
}

extern "C" int ec_window_p384_strict(const int32_t* scalars, const int32_t* xs,
                                     const int32_t* ys, int32_t* ax, int32_t* ay, int32_t* z,
                                     int64_t B, void* stream) {
  return launch_wide<12, kThreadsP384>(window_strict_p384_kernel, scalars, xs, ys, ax, ay,
                                     z, B, stream);
}

extern "C" int ec_window_p384_smem(void) { return smem_granted(window_p384_kernel); }
extern "C" int ec_window_p384_strict_smem(void) {
  return smem_granted(window_strict_p384_kernel);
}
