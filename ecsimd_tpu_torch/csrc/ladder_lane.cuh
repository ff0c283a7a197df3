// Kernel A's lane, the co-Z masked-swap ladder, over the field of the
// including namespace (sm_90a). ladder.cu includes this file inside
// namespaces p256, secp256k1 and w25519, each after the field's coz header,
// so the lane is written once; the file has no include guard and includes
// nothing. ladder.cu says what the kernel computes and what bounds it.

// Lane i: k * P for the classical scalar planes and the affine point's
// coordinates in the field's internal form (z = 1); stores Jacobian (X, Y,
// Z) planes in the internal form.
__device__ __forceinline__ void ladder_lane(const int32_t* scalars, const int32_t* xs,
                                            const int32_t* ys, int32_t* ax_out,
                                            int32_t* ay_out, int32_t* z_out, int64_t B,
                                            int64_t i) {
  const fe x = fe_load(xs, B, i);
  const fe y = fe_load(ys, B, i);
  fe ax, ay, bx, by, z;
  tplu(x, y, bx, by, ax, ay, z);  // base = 3P, acc = P

  const uint32_t k0 = scalar_word(scalars, B, i, 0);
  const uint32_t m1 = (k0 >> 1) & 1u;
  fe_swap_if(m1, ax, bx);
  fe_swap_if(m1, ay, by);

  for (int w = 0; w < 8; ++w) {
    const uint32_t kw = scalar_word(scalars, B, i, w);
    for (int bit = (w == 0 ? 2 : 0); bit < 32; ++bit) {
      const uint32_t m = (kw >> bit) & 1u;
      fe_swap_if(m, ax, bx);
      fe_swap_if(m, ay, by);
      zdau(bx, by, ax, ay, z, bx, by, ax, ay, z);
      fe_swap_if(m, ax, bx);
      fe_swap_if(m, ay, by);
    }
  }

  // parity fixup: even scalars got (k+1)P; subtract P
  fe sx, sy, sz;
  add_z2_1(ax, ay, z, x, fe_neg(y), sx, sy, sz);
  const uint32_t even = (k0 & 1u) ^ 1u;
  fe_store(ax_out, B, i, fe_select(even, sx, ax));
  fe_store(ay_out, B, i, fe_select(even, sy, ay));
  fe_store(z_out, B, i, fe_select(even, sz, z));
}
