// Kernel E's lane, the signed w = 4 window, plain and strict, over the field
// of the including namespace (sm_90a). window.cu and window_<curve>.cu
// include this file inside namespaces p256, secp256k1, w25519, p384 and
// p521, each after the field's coz header and window.cuh, so the lane is
// written once; the file has no include guard and includes nothing.
// window.cuh says what the kernel computes and what bounds it.
//
// The windows walk the scalar's 4 D windows (D = kDigits, 16, 24 or 33),
// as the JAX package's loop over digits does: 32-bit words kWords - 1 .. 0,
// eight windows a word, but four in P-521's top word, which holds one
// digit (bits 512 .. 527).

// Lane i: k * P for the classical scalar planes and the affine point's
// coordinates in the field's internal form (z = 1, the field's 1); stores
// Jacobian (X, Y, Z) planes in the internal form. jac_dbl is the curve's
// own doubling (a = -3, a = 0 or general a).
template <bool kStrict, class Table>
__device__ __forceinline__ void window_lane(const int32_t* scalars, const int32_t* xs,
                                            const int32_t* ys, int32_t* ax_out,
                                            int32_t* ay_out, int32_t* z_out, int64_t B,
                                            int64_t i, Table& tbl) {
  constexpr int kTopOff = kDigits % 2 ? 12 : 28;  // the top word's first window
  const fe one = fe_one();
  fe accx = fe_load(xs, B, i);
  fe accy = fe_load(ys, B, i);
  fe accz = one;

  // table of odd multiples: T[0] = P, T[t] = T[t-1] + 2P
  fe dx, dy, dz, tx = accx, ty = accy, tz = one;
  jac_dbl(accx, accy, one, dx, dy, dz);
  wtable::put(tbl, 0, tx, ty, tz);
#pragma unroll 1
  for (int t = 1; t < wtable::kEntries; ++t) {
    fe h, r;
    jac_add(tx, ty, tz, dx, dy, dz, tx, ty, tz, h, r);
    wtable::put(tbl, t, tx, ty, tz);
  }

#pragma unroll 1
  for (int w = kWords - 1; w >= 0; --w) {
    // 64 bits of k from bit 32w: the window at offset 28 spills into word w+1
    const uint64_t kk =
        (uint64_t)scalar_word(scalars, B, i, w) |
        ((uint64_t)(w < kWords - 1 ? scalar_word(scalars, B, i, w + 1) : 0u) << 32);
#pragma unroll 1
    for (int off = w == kWords - 1 ? kTopOff : 28; off >= 0; off -= 4) {
      const uint32_t v = ((uint32_t)(kk >> off) & 31u) | 1u;  // digit v - 16, odd
      const uint32_t neg = (v >> 4) ^ 1u;                     // v < 16
      const uint32_t m = 0u - neg;
      const uint32_t mag = ((v - 16u) ^ m) - m;               // |v - 16|, branch-free
#pragma unroll 1
      for (int s = 0; s < 4; ++s) jac_dbl(accx, accy, accz, accx, accy, accz);
      // looked up after the doublings, so the entry is not live across them
      fe ex, ey, ez;
      wtable::get(tbl, (mag - 1u) >> 1, ex, ey, ez);
      ey = fe_select(neg, fe_neg(ey), ey);
      if constexpr (kStrict) {
        add_complete(accx, accy, accz, ex, ey, ez, accx, accy, accz);
      } else {
        fe h, r;
        jac_add(accx, accy, accz, ex, ey, ez, accx, accy, accz, h, r);
      }
    }
  }

  // parity fixup: even scalars got (k+1)P; add -P
  const fe x = fe_load(xs, B, i);
  const fe ny = fe_neg(fe_load(ys, B, i));
  fe sx, sy, sz;
  if constexpr (kStrict) {
    add_complete(accx, accy, accz, x, ny, one, sx, sy, sz);
  } else {
    add_z2_1(accx, accy, accz, x, ny, sx, sy, sz);
  }
  const uint32_t even = (scalar_word(scalars, B, i, 0) & 1u) ^ 1u;
  fe_store(ax_out, B, i, fe_select(even, sx, accx));
  fe_store(ay_out, B, i, fe_select(even, sy, accy));
  fe_store(z_out, B, i, fe_select(even, sz, accz));
}
