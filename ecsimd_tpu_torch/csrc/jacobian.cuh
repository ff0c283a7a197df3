// Jacobian adds over the field of the including namespace (sm_90a).
//
// Written once for every field: coz_p256.cuh, coz_secp256k1.cuh,
// coz_w25519.cuh, coz_p384.cuh and coz_p521.cuh include this file inside their namespaces, each after its
// own fe_* arithmetic and its curve's jac_dbl. So this file has no
// include guard and includes nothing.
//
// Replace ecsimd_tpu/kernels/coz.py:add_z2_1_any, add_any (jac_add_generic),
// aff_add_any and add_complete_any; plain twins: curves/group.py add_z2_1,
// jac_add, aff_add and add_complete. Each follows the JAX package's
// formula sequence operation for operation; every field result is
// canonical, so the Jacobian planes agree bit for bit. Inputs are taken
// by value so that callers may pass outputs that alias inputs.
//
// Field multiplies (M) and squarings (S): add_z2_1 7M + 4S, jac_add
// 12M + 4S, aff_add 4M + 2S, add_complete jac_add + jac_dbl.

// Mixed add with Z2 == 1: (x1, y1, z1) + (x2, y2, 1).
__device__ __forceinline__ void add_z2_1(fe x1, fe y1, fe z1, fe x2, fe y2,
                                         fe& x3, fe& y3, fe& z3) {
  fe z1z1 = fe_sqr(z1);
  fe u2 = fe_mul(x2, z1z1);
  fe s2 = fe_mul(fe_mul(y2, z1), z1z1);
  fe h = fe_sub(u2, x1);
  fe hh = fe_sqr(h);
  fe j = fe_mul4(h, hh);
  fe r = fe_dbl(fe_sub(s2, y1));
  fe v = fe_mul4(x1, hh);
  fe x = fe_sub(fe_sub(fe_sqr(r), j), fe_dbl(v));
  fe y = fe_sub(fe_mul(r, fe_sub(v, x)), fe_mul2(y1, j));
  z3 = fe_sub(fe_sub(fe_sqr(fe_add(z1, h)), z1z1), hh);
  x3 = x;
  y3 = y;
}

// Affine + affine -> Jacobian (z1 = z2 = 1): H = x2 - x1, r = y2 - y1,
// X3 = r^2 - H^3 - 2 x1 H^2, Y3 = r (x1 H^2 - X3) - y1 H^3, Z3 = H. The
// comb tree's first level; degenerate when x1 == x2 (H == 0).
__device__ __forceinline__ void aff_add(fe x1, fe y1, fe x2, fe y2, fe& x3, fe& y3, fe& z3) {
  fe h = fe_sub(x2, x1);
  fe r = fe_sub(y2, y1);
  fe hh = fe_sqr(h);
  fe hhh = fe_mul(h, hh);
  fe v = fe_mul(x1, hh);
  fe x = fe_sub(fe_sub(fe_sqr(r), hhh), fe_dbl(v));
  y3 = fe_sub(fe_mul(r, fe_sub(v, x)), fe_mul(y1, hhh));
  x3 = x;
  z3 = h;
}

// General Jacobian add (add-2007-bl with Z3 = Z1 Z2 H, 12M + 4S), also
// returning h = U2 - U1 and r = S2 - S1; degenerate when h == 0 (equal or
// opposite points).
__device__ __forceinline__ void jac_add(fe x1, fe y1, fe z1, fe x2, fe y2, fe z2,
                                        fe& x3, fe& y3, fe& z3, fe& h, fe& r) {
  fe z1z1 = fe_sqr(z1);
  fe z2z2 = fe_sqr(z2);
  fe u1 = fe_mul(x1, z2z2);
  fe u2 = fe_mul(x2, z1z1);
  fe s1 = fe_mul(fe_mul(y1, z2z2), z2);
  fe s2 = fe_mul(fe_mul(y2, z1z1), z1);
  fe hh_ = fe_sub(u2, u1);
  fe rr = fe_sub(s2, s1);
  fe hh = fe_sqr(hh_);
  fe hhh = fe_mul(hh_, hh);
  fe v = fe_mul(u1, hh);
  fe x = fe_sub(fe_sub(fe_sqr(rr), hhh), fe_dbl(v));
  y3 = fe_sub(fe_mul(rr, fe_sub(v, x)), fe_mul(s1, hhh));
  z3 = fe_mul(fe_mul(z1, z2), hh_);
  x3 = x;
  h = hh_;
  r = rr;
}

// Exception-free add: the general add with the cases it corrupts completed
// by masks, without branches — P1 == P2 (h == 0, r == 0) -> jac_dbl(P1);
// P1 == -P2 (h == 0, r != 0) -> infinity (z = 0); P1 == inf (z1 == 0) ->
// (x2, y2, 1). P2 must be finite. Both the add and the doubling are always
// computed, so the time does not depend on which case a lane is in.
__device__ __forceinline__ void add_complete(fe x1, fe y1, fe z1, fe x2, fe y2, fe z2,
                                             fe& x3, fe& y3, fe& z3) {
  const uint32_t inf1 = fe_is_zero(z1);
  fe ax, ay, az, dx, dy, dz;
  uint32_t hz, rz;
  {
    // h and r end here: only their zero tests stay live across the doubling
    fe h, r;
    jac_add(x1, y1, z1, x2, y2, z2, ax, ay, az, h, r);
    hz = fe_is_zero(h);
    rz = fe_is_zero(r);
  }
  jac_dbl(x1, y1, z1, dx, dy, dz);
  const uint32_t same = hz & rz & (inf1 ^ 1u);
  const uint32_t opp = hz & (rz ^ 1u) & (inf1 ^ 1u);
  az = fe_select(same, dz, fe_select(opp, fe_zero(), az));
  x3 = fe_select(inf1, x2, fe_select(same, dx, ax));
  y3 = fe_select(inf1, y2, fe_select(same, dy, ay));
  z3 = fe_select(inf1, fe_one(), az);
}
