// Jacobian formulas on Wei25519 (general a) for one lane per thread
// (sm_90a).
//
// Replaces ecsimd_tpu/kernels/coz.py:jac_dbl_general_a (the doubling that
// dbl_any picks for a != -3) on Wei25519, the short-Weierstrass lift of
// Curve25519, and instantiates the shared adds of jacobian.cuh over the
// 2^255 - 19 field. Plain twin: curves/group.py jac_dbl. Same formula
// sequence, so the canonical planes agree bit for bit. Only kernel B's
// non-strict chain (add_z2_1) runs on this curve; add_complete, which
// calls jac_dbl, is compiled and not launched.
//
// What bounds it: field multiplies — the doubling is 2M + 8S, add_z2_1
// 7M + 4S.

#pragma once

#include "field_w25519.cuh"

namespace w25519 {

// Wei25519's a
#define WEI25519_A \
  {0x4914A144u, 0xAAAAAA98u, 0xAAAAAAAAu, 0xAAAAAAAAu, 0xAAAAAAAAu, 0xAAAAAAAAu, 0xAAAAAAAAu, 0x2AAAAAAAu}

// dbl-2007-bl for any a (2M + 8S): M = 3 X^2 + a Z^4. Doubling of infinity
// stays at infinity (z3 = 2 y1 z1).
__device__ __forceinline__ void jac_dbl(fe x1, fe y1, fe z1, fe& x3, fe& y3, fe& z3) {
  const fe a = {WEI25519_A};
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

// add_z2_1, jac_add and add_complete, written once for every field.
#include "jacobian.cuh"

}  // namespace w25519
