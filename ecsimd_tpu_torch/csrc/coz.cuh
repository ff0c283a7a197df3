// Co-Z formulas over the field of the including namespace (sm_90a): the
// ladder's DBLU, ZADDU, TPLU and ZDAU.
//
// Written once for every field: coz_p256.cuh, coz_secp256k1.cuh and
// coz_w25519.cuh include this file inside their namespaces, after the
// field's fe_* arithmetic and the curve's a in the field's internal form,
// curve_a(). So this file has no include guard and includes nothing.
//
// Replace ecsimd_tpu/kernels/ladder.py:_ladder_core's steps (its fused
// ZDAU, TPLU) and the curves/group.py formulas they are bit-identical to
// (dblu, zaddu, tplu, zdau); plain twins: the port's curves/group.py. Each
// follows the JAX package's formula sequence operation for operation; every
// field result is canonical, so the Jacobian planes agree bit for bit.
// Co-Z arithmetic after Goundar-Joye-Miyaji, eprint 2010/309. Inputs are
// taken by value so that callers may pass outputs that alias inputs.
//
// Field multiplies (M) and squarings (S): DBLU 1M + 5S, ZADDU 5M + 2S,
// TPLU 6M + 7S, ZDAU 9M + 7S.

// Initial co-Z doubling, Z == 1 assumed: (2P, P') sharing z. With Z = 1 the
// a Z^4 term is a itself: M = 3 x^2 + a, one add for every curve.
__device__ __forceinline__ void dblu(fe x1, fe y1, fe& x2p, fe& y2p, fe& xu, fe& yu, fe& z) {
  const fe am = curve_a();
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
