// Jacobian formulas on Wei25519 (general a) for one lane per thread
// (sm_90a).
//
// Replaces ecsimd_tpu/kernels/coz.py:jac_dbl_general_a (the doubling that
// dbl_any picks for a != -3) on Wei25519, the short-Weierstrass lift of
// Curve25519, and instantiates the shared adds of jacobian.cuh and the co-Z
// formulas of coz.cuh over the 2^255 - 19 field. Plain twin:
// curves/group.py jac_dbl. Same formula sequence, so the canonical planes
// agree bit for bit.
//
// What bounds it: field multiplies — the doubling is 2M + 8S, add_z2_1
// 7M + 4S, add_complete 14M + 12S.

#pragma once

#include "field_w25519.cuh"

namespace w25519 {

// Wei25519's a (the Crandall field's internal form is the classical one)
#define WEI25519_A \
  {0x4914A144u, 0xAAAAAA98u, 0xAAAAAAAAu, 0xAAAAAAAAu, 0xAAAAAAAAu, 0xAAAAAAAAu, 0xAAAAAAAAu, 0x2AAAAAAAu}

__device__ __forceinline__ fe curve_a() {
  const fe a = {WEI25519_A};
  return a;
}

// dbl-2007-bl for any a (2M + 8S): M = 3 X^2 + a Z^4. Doubling of infinity
// stays at infinity (z3 = 2 y1 z1).
__device__ __forceinline__ void jac_dbl(fe x1, fe y1, fe z1, fe& x3, fe& y3, fe& z3) {
  const fe a = curve_a();
  fe xx = fe_sqr(x1);
  fe yy = fe_sqr(y1);
  fe yyyy = fe_sqr(yy);
  fe zz = fe_sqr(z1);
  fe s = fe_dbl(fe_sub(fe_sub(fe_sqr(fe_add(x1, yy)), xx), yyyy));
  fe m = fe_add(fe_add(fe_dbl(xx), xx), fe_mul(a, fe_sqr(zz)));
  fe t = fe_sub(fe_sqr(m), fe_dbl(s));
  y3 = fe_sub(fe_mul(m, fe_sub(s, t)), fe_dbl(fe_dbl(fe_dbl(yyyy))));
  z3 = fe_sub(fe_sub(fe_sqr(fe_add(y1, z1)), yy), zz);
  x3 = t;
}

// add_z2_1, jac_add and add_complete, and the co-Z formulas, written once
// for every field.
#include "jacobian.cuh"
#include "coz.cuh"

}  // namespace w25519
