// Jacobian formulas on P-256 (a = -3) for one lane per thread (sm_90a).
//
// Replaces ecsimd_tpu/kernels/coz.py:jac_dbl (plain twin curves/group.py
// dbl_am3, the doubling that dbl_any picks for a = -3), and instantiates
// the shared adds of jacobian.cuh and the co-Z formulas of coz.cuh over the
// Solinas field with the curve's a. Each function follows the JAX package's
// formula sequence operation for operation. The JAX kernels fuse whole
// coordinate polynomials into one Solinas reduction; here every operation
// reduces on its own, which gives the same canonical residues, hence the
// same Jacobian planes. Inputs are taken by value so that callers may pass
// outputs that alias inputs.
//
// What bounds these formulas: field multiplies (jac_dbl: 3 mul + 5 sqr;
// add_complete: 15 mul + 9 sqr; coz.cuh and jacobian.cuh count theirs) —
// 32-bit multiply-add throughput; all state stays in registers.

#pragma once

#include "field_p256.cuh"

namespace p256 {

// a = p - 3 (the Solinas field's internal form is the classical one)
#define P256_A \
  {0xFFFFFFFCu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0u, 0u, 0u, 1u, 0xFFFFFFFFu}

__device__ __forceinline__ fe curve_a() {
  const fe a = {P256_A};
  return a;
}

// --- free-standing Jacobian formulas (window kernel, strict comb) -------------
// Replace ecsimd_tpu/kernels/coz.py:jac_dbl (plain twin curves/group.py
// dbl_am3), which add_complete calls.

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

// add_z2_1, jac_add and add_complete, and the co-Z formulas, written once
// for every field.
#include "jacobian.cuh"
#include "coz.cuh"

}  // namespace p256
