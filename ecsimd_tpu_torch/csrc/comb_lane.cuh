// Kernel B's per-lane chain over the field of the including namespace
// (sm_90a). comb.cu includes this file inside namespace p256 and inside
// namespace secp256k1, after the field's coz header, so the chain is written
// once; the file has no include guard and includes nothing. The table
// staging and the masked scan are field-independent (comb.cu, namespace
// comb).

// acc + (ex, ey, 1): the mixed add, or the complete add when strict.
template <bool kStrict>
__device__ __forceinline__ void comb_add(fe x1, fe y1, fe z1, fe ex, fe ey, fe& x3, fe& y3,
                                         fe& z3) {
  if constexpr (kStrict) {
    add_complete(x1, y1, z1, ex, ey, fe_one(), x3, y3, z3);
  } else {
    add_z2_1(x1, y1, z1, ex, ey, x3, y3, z3);
  }
}

// One lane of the comb. Every thread of the block runs every position, the
// block's staging and barriers included; `active` says whether lane i
// exists, and only active lanes store.
template <bool kStrict>
__device__ __forceinline__ void comb_lane(const int32_t* scalars, const uint4* tables,
                                          const int32_t* negbase, int32_t* ax_out,
                                          int32_t* ay_out, int32_t* z_out, int64_t B,
                                          int64_t i, bool active, uint4 (*buf)[comb::kBufVecs]) {
  fe x, y, z;
  comb::stage_position(tables, 0, buf[0]);
#pragma unroll 1
  for (int j = 0; j < comb::kPositions; ++j) {
    if (j + 1 < comb::kPositions) {
      comb::stage_position(tables, j + 1, buf[(j + 1) & 1]);
      comb::wait_staged<1>();
    } else {
      comb::wait_staged<0>();
    }
    __syncthreads();
    const uint32_t e = comb::entry_index(scalars, B, i, j);
    if (j == 0) {  // position 0 keeps all 256 signed entries (the top digit is folded in)
      comb::scan<comb::kEntries0>(buf[0], e, x, y);
      z = fe_one();
    } else {  // entry e is +-(2m+1) 2^(8j) B: magnitude m read by masks, sign by a masked negation
      const uint32_t neg = e < 128u ? 1u : 0u;
      const uint32_t m = (e & 127u) ^ ((0u - neg) & 127u);
      fe ex, ey;
      comb::scan<comb::kHalfEntries>(buf[j & 1], m, ex, ey);
      ey = fe_select(neg, fe_neg(ey), ey);
      comb_add<kStrict>(x, y, z, ex, ey, x, y, z);
    }
    __syncthreads();  // the next staging overwrites this buffer
  }
  // parity fixup: even k computed (k+1)B; add -B
  fe sx, sy, sz;
  comb_add<kStrict>(x, y, z, fe_from_digits(negbase), fe_from_digits(negbase + 16), sx, sy,
                    sz);
  const uint32_t even = ((uint32_t)scalars[i] & 1u) ^ 1u;
  if (active) {
    fe_store(ax_out, B, i, fe_select(even, sx, x));
    fe_store(ay_out, B, i, fe_select(even, sy, y));
    fe_store(z_out, B, i, fe_select(even, sz, z));
  }
}
