// The a = -3 Jacobian doubling over the field of the including namespace
// (sm_90a): coz_p256.cuh, coz_p384.cuh and coz_p521.cuh include this file
// inside their namespaces, after the field's fe_* arithmetic and before
// jacobian.cuh (whose add_complete calls it), so it has no include guard
// and includes nothing.
//
// Replaces ecsimd_tpu/kernels/coz.py:jac_dbl (plain twin curves/group.py
// dbl_am3, the doubling that dbl_any picks for a = -3), used by the window
// kernel and the strict comb. Same formula sequence as the JAX package,
// operation for operation; every field result is canonical, so the
// Jacobian planes agree bit for bit.

// dbl-2001-b for a = -3 (3M + 5S). Doubling of infinity stays at infinity
// (z3 = 2 y1 z1).
__device__ __forceinline__ void jac_dbl(fe x1, fe y1, fe z1, fe& x3, fe& y3, fe& z3) {
  fe delta = fe_sqr(z1);
  fe gamma = fe_sqr(y1);
  fe beta4 = fe_mul4(x1, gamma);
  fe t = fe_mul(fe_sub(x1, delta), fe_add(x1, delta));
  fe alpha = fe_add(fe_dbl(t), t);
  fe x = fe_sub(fe_sqr(alpha), fe_dbl(beta4));
  fe g8 = fe_dbl(fe_dbl(fe_dbl(fe_sqr(gamma))));
  y3 = fe_sub(fe_mul(alpha, fe_sub(beta4, x)), g8);
  z3 = fe_sub(fe_sub(fe_sqr(fe_add(y1, z1)), gamma), delta);
  x3 = x;
}
