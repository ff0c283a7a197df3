// Kernel E, the signed w = 4 window, plain and strict, on secp256k1
// (NVIDIA Hopper, sm_90a): the C entry points of window.cuh's kernels over
// window_lane.cuh, which say what the kernel computes and how. Replaces
// ecsimd_tpu/kernels/window.py:_window_kernel.

#include "coz_secp256k1.cuh"
#include "window.cuh"

namespace secp256k1 {
#include "window_lane.cuh"
}  // namespace secp256k1

namespace {
EC_WINDOW_KERNEL(window_secp256k1_kernel, secp256k1, false)
EC_WINDOW_KERNEL(window_strict_secp256k1_kernel, secp256k1, true)
}  // namespace

// scalars: (16, B) int32 classical digit planes; xs, ys: (16, B) affine
// coordinates (z = 1) in the field's internal form; ax, ay, z: (16, B)
// Jacobian outputs. Launch on `stream`; return cudaGetLastError().
extern "C" int ec_window_secp256k1(const int32_t* scalars, const int32_t* xs,
                                   const int32_t* ys, int32_t* ax, int32_t* ay, int32_t* z,
                                   int64_t B, void* stream) {
  return launch(window_secp256k1_kernel, scalars, xs, ys, ax, ay, z, B, stream);
}

extern "C" int ec_window_secp256k1_strict(const int32_t* scalars, const int32_t* xs,
                                          const int32_t* ys, int32_t* ax, int32_t* ay,
                                          int32_t* z, int64_t B, void* stream) {
  return launch(window_strict_secp256k1_kernel, scalars, xs, ys, ax, ay, z, B, stream);
}
