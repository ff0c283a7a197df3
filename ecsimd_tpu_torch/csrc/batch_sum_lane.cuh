// Kernel M's lane, one level of the batch reduction tree, over the field of
// the including namespace (sm_90a). batch_sum.cu includes this file inside
// namespaces p256, secp256k1 and w25519, batch_sum_p384.cu and
// batch_sum_p521.cu inside p384 and p521, each after the curve's coz header
// (the field's fe_* arithmetic, the curve's jac_dbl and jacobian.cuh's
// jac_add), so the lane is written once; the file has no include guard and
// includes nothing.
//
// Replaces ecsimd_tpu/curves/group.py:batch_sum (plain XLA, no Pallas
// kernel); plain twin: curves/group.py batch_sum in this package. Each
// level adds lane i to lane i + h (h = n / 2) with the complete add and
// carries an odd last lane, as the JAX package's loop does, so the tree,
// and with it the output's Jacobian representative, is the same.

// The exception-free Jacobian add of ecsimd_tpu/curves/group.py:
// jac_add_complete, select for select: P1 == P2 (h == 0, r == 0) ->
// jac_dbl(P1); P1 == -P2 (h == 0, r != 0) -> z = 0; P1 at infinity (z1 == 0)
// -> (x2, y2, z2); P2 at infinity -> (x1, y1, z1). Either operand may be at
// infinity (jacobian.cuh's add_complete takes P2 finite and returns z = 1
// where P1 is at infinity). jac_dbl is the curve's own doubling: dbl-2001-b
// on the a = -3 curves and the a = 0 form on secp256k1 are the general-a
// formula of the JAX package (M = 3 X^2 + a Z^4) as polynomials, so they
// give its residues on every input, z = 0 included. Both the add and the
// doubling are always computed: the time does not depend on the case.
__device__ __forceinline__ void add_complete_any(fe x1, fe y1, fe z1, fe x2, fe y2, fe z2,
                                                 fe& x3, fe& y3, fe& z3) {
  const uint32_t inf1 = fe_is_zero(z1);
  const uint32_t inf2 = fe_is_zero(z2);
  fe ax, ay, az, dx, dy, dz;
  uint32_t hz, rz;
  {
    fe h, r;
    jac_add(x1, y1, z1, x2, y2, z2, ax, ay, az, h, r);
    hz = fe_is_zero(h);
    rz = fe_is_zero(r);
  }
  jac_dbl(x1, y1, z1, dx, dy, dz);
  const uint32_t finite = (inf1 ^ 1u) & (inf2 ^ 1u);
  const uint32_t same = hz & rz & finite;
  const uint32_t opp = hz & (rz ^ 1u) & finite;
  ax = fe_select(same, dx, ax);
  ay = fe_select(same, dy, ay);
  az = fe_select(same, dz, fe_select(opp, fe_zero(), az));
  x3 = fe_select(inf1, x2, fe_select(inf2, x1, ax));
  y3 = fe_select(inf1, y2, fe_select(inf2, y1, ay));
  z3 = fe_select(inf1, z2, fe_select(inf2, z1, az));
}

// Output lane i of a level over n input lanes (internal-form (D, n) planes
// in, (D, (n + 1) / 2) planes out): lane i + lane i + n / 2 for i < n / 2;
// for odd n, lane n / 2 of the output is the input's last lane.
__device__ __forceinline__ void batch_sum_lane(const int32_t* xs, const int32_t* ys,
                                               const int32_t* zs, int32_t* ox, int32_t* oy,
                                               int32_t* oz, int64_t n, int64_t i) {
  const int64_t h = n / 2;
  const int64_t m = n - h;  // the output's lanes
  if (i < h) {
    fe x, y, z;
    add_complete_any(fe_load(xs, n, i), fe_load(ys, n, i), fe_load(zs, n, i),
                     fe_load(xs, n, i + h), fe_load(ys, n, i + h), fe_load(zs, n, i + h),
                     x, y, z);
    fe_store(ox, m, i, x);
    fe_store(oy, m, i, y);
    fe_store(oz, m, i, z);
  } else {  // i == h < m: the odd tail, carried
    fe_store(ox, m, i, fe_load(xs, n, n - 1));
    fe_store(oy, m, i, fe_load(ys, n, n - 1));
    fe_store(oz, m, i, fe_load(zs, n, n - 1));
  }
}
