// Kernel E, the signed w = 4 window, plain and strict, on Wei25519
// (NVIDIA Hopper, sm_90a): the C entry points of window.cuh's kernels over
// window_lane.cuh, which say what the kernel computes and how. Replaces
// ecsimd_tpu/kernels/window.py:_window_kernel.

#include "coz_w25519.cuh"
#include "window.cuh"

namespace w25519 {
#include "window_lane.cuh"
}  // namespace w25519

namespace {
EC_WINDOW_KERNEL(window_w25519_kernel, w25519, false)
EC_WINDOW_KERNEL(window_strict_w25519_kernel, w25519, true)
}  // namespace

// scalars: (16, B) int32 classical digit planes; xs, ys: (16, B) affine
// coordinates (z = 1) in the field's internal form; ax, ay, z: (16, B)
// Jacobian outputs. Launch on `stream`; return cudaGetLastError().
extern "C" int ec_window_w25519(const int32_t* scalars, const int32_t* xs,
                                const int32_t* ys, int32_t* ax, int32_t* ay, int32_t* z,
                                int64_t B, void* stream) {
  return launch(window_w25519_kernel, scalars, xs, ys, ax, ay, z, B, stream);
}

extern "C" int ec_window_w25519_strict(const int32_t* scalars, const int32_t* xs,
                                       const int32_t* ys, int32_t* ax, int32_t* ay,
                                       int32_t* z, int64_t B, void* stream) {
  return launch(window_strict_w25519_kernel, scalars, xs, ys, ax, ay, z, B, stream);
}
