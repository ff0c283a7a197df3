// Jacobian formulas on secp256k1 (a = 0) for one lane per thread (sm_90a).
//
// Replaces ecsimd_tpu/kernels/coz.py:jac_dbl_general_a (the doubling that
// dbl_any picks for a != -3) for a = 0, and instantiates the shared adds of
// jacobian.cuh and the co-Z formulas of coz.cuh over the Montgomery field.
// Plain twin: curves/group.py jac_dbl (general a; the a term vanishes for
// a = 0). Same formula sequence, so the canonical Montgomery-form planes
// agree bit for bit.
//
// What bounds it: field multiplies — the doubling is 1M + 7S, jac_add
// 12M + 4S, add_complete 13M + 11S, add_z2_1 7M + 4S.

#pragma once

#include "field_secp256k1.cuh"

namespace secp256k1 {

// a = 0, in Montgomery form 0 too
#define SECP256K1_A \
  {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u}

__device__ __forceinline__ fe curve_a() {
  const fe a = {SECP256K1_A};
  return a;
}

// dbl-2007-bl for a = 0 (1M + 7S): M = 3 X^2. Doubling of infinity stays at
// infinity (z3 = 2 y1 z1).
__device__ __forceinline__ void jac_dbl(fe x1, fe y1, fe z1, fe& x3, fe& y3, fe& z3) {
  fe xx = fe_sqr(x1);
  fe yy = fe_sqr(y1);
  fe yyyy = fe_sqr(yy);
  fe zz = fe_sqr(z1);
  fe s = fe_dbl(fe_sub(fe_sub(fe_sqr(fe_add(x1, yy)), xx), yyyy));
  fe m = fe_add(fe_dbl(xx), xx);
  fe t = fe_sub(fe_sqr(m), fe_dbl(s));
  y3 = fe_sub(fe_mul(m, fe_sub(s, t)), fe_dbl(fe_dbl(fe_dbl(yyyy))));
  z3 = fe_sub(fe_sub(fe_sqr(fe_add(y1, z1)), yy), zz);
  x3 = t;
}

// add_z2_1, jac_add and add_complete, and the co-Z formulas, written once
// for every field.
#include "jacobian.cuh"
#include "coz.cuh"

}  // namespace secp256k1
