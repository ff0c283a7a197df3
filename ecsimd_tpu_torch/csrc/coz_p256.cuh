// Co-Z Jacobian formulas on P-256 for one lane per thread (sm_90a).
//
// Replaces ecsimd_tpu/kernels/coz.py (zdau_fused, add_z2_1_fused, jac_dbl)
// and the curves/group.py formulas it is bit-identical to (dblu, zaddu,
// tplu); the adds shared with secp256k1 are in jacobian.cuh. Each
// function follows the JAX package's formula sequence operation for
// operation. The JAX kernels fuse whole coordinate polynomials into one
// Solinas reduction; here every operation reduces on its own, which gives
// the same canonical residues, hence the same Jacobian planes.
//
// Co-Z arithmetic after Goundar-Joye-Miyaji, eprint 2010/309. Inputs are
// taken by value so that callers may pass outputs that alias inputs.
//
// What bounds these formulas: field multiplies (ZDAU: 9 mul + 7 sqr,
// ADD_Z2_1: 7 mul + 4 sqr, jac_dbl: 3 mul + 5 sqr, jac_add: 12 mul + 4 sqr,
// add_complete: 15 mul + 9 sqr)
// — 32-bit multiply-add throughput; all state stays in registers.

#pragma once

#include "field_p256.cuh"

namespace p256 {

// a = p - 3
#define P256_A \
  {0xFFFFFFFCu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0u, 0u, 0u, 1u, 0xFFFFFFFFu}

// Initial co-Z doubling, Z == 1 assumed: (2P, P') sharing z.
__device__ __forceinline__ void dblu(fe x1, fe y1, fe& x2p, fe& y2p, fe& xu, fe& yu, fe& z) {
  const fe am = {P256_A};
  fe b = fe_sqr(x1);
  fe e = fe_sqr(y1);
  fe l = fe_sqr(e);
  fe s = fe_dbl(fe_sub(fe_sub(fe_sqr(fe_add(x1, e)), b), l));
  fe m = fe_add(fe_add(fe_dbl(b), b), am);
  fe x = fe_sub(fe_sqr(m), fe_dbl(s));
  fe l8 = fe_dbl(fe_dbl(fe_dbl(l)));
  fe y = fe_sub(fe_mul(m, fe_sub(s, x)), l8);
  z = fe_dbl(y1);
  x2p = x;
  y2p = y;
  xu = s;
  yu = l8;
}

// Co-Z addition with update: (P, Q) with common z -> (P+Q, P') with z3.
__device__ __forceinline__ void zaddu(fe x1, fe y1, fe x2, fe y2, fe z,
                                      fe& x3, fe& y3, fe& xu, fe& yu, fe& z3) {
  fe dx = fe_sub(x1, x2);
  fe c = fe_sqr(dx);
  fe w1 = fe_mul(x1, c);
  fe w2 = fe_mul(x2, c);
  fe dy = fe_sub(y1, y2);
  fe d = fe_sqr(dy);
  fe a1 = fe_mul(y1, fe_sub(w1, w2));
  fe x = fe_sub(fe_sub(d, w1), w2);
  fe y = fe_sub(fe_mul(dy, fe_sub(w1, x)), a1);
  z3 = fe_mul(z, dx);
  x3 = x;
  y3 = y;
  xu = w1;
  yu = a1;
}

// Co-Z tripling: (3P, P') sharing z.
__device__ __forceinline__ void tplu(fe x1, fe y1, fe& x3, fe& y3, fe& xu, fe& yu, fe& z) {
  fe x2p, y2p, su, lu, zz;
  dblu(x1, y1, x2p, y2p, su, lu, zz);
  zaddu(su, lu, x2p, y2p, zz, x3, y3, xu, yu, z);
}

// Co-Z double-add with update: (P, Q) with common z -> (2P+Q, Q') with z3.
// The ladder's per-bit step.
__device__ __forceinline__ void zdau(fe x1, fe y1, fe x2, fe y2, fe z,
                                     fe& x3, fe& y3, fe& xq, fe& yq, fe& z3) {
  fe dx = fe_sub(x1, x2);
  fe cp = fe_sqr(dx);
  fe w1p = fe_mul(x1, cp);
  fe w2p = fe_mul(x2, cp);
  fe dy = fe_sub(y1, y2);
  fe dp = fe_sqr(dy);
  fe a1p = fe_mul(y1, fe_sub(w1p, w2p));
  fe x3pc = fe_sub(fe_sub(dp, w1p), w2p);
  fe c = fe_sqr(fe_sub(x3pc, w1p));
  fe a1p2 = fe_dbl(a1p);
  fe y3p = fe_sub(fe_sub(fe_sub(fe_sqr(fe_add(dy, fe_sub(w1p, x3pc))), dp), c), a1p2);
  fe w1 = fe_mul4(x3pc, c);
  fe w2 = fe_mul4(w1p, c);
  fe t_minus = fe_sub(y3p, a1p2);
  fe d = fe_sqr(t_minus);
  fe a1 = fe_mul(y3p, fe_sub(w1, w2));
  fe x = fe_sub(fe_sub(d, w1), w2);
  fe y = fe_sub(fe_mul(t_minus, fe_sub(w1, x)), a1);
  fe zn = fe_mul(z, fe_sub(fe_sub(fe_sqr(fe_sub(fe_add(dx, x3pc), w1p)), cp), c));
  fe t_plus = fe_add(y3p, a1p2);
  fe dc = fe_sqr(t_plus);
  fe xn = fe_sub(fe_sub(dc, w1), w2);
  fe yn = fe_sub(fe_mul(t_plus, fe_sub(w1, xn)), a1);
  x3 = x;
  y3 = y;
  xq = xn;
  yq = yn;
  z3 = zn;
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

// add_z2_1, jac_add and add_complete, written once for every field.
#include "jacobian.cuh"

}  // namespace p256
