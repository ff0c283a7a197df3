// The comb's per-lane entry read and fix-up, and kernel B's per-lane chain,
// over the field of the including namespace (sm_90a). comb.cu, comb_tree.cu,
// comb_pipe.cu and kernel L's sources include this file inside namespaces
// p256, secp256k1 and w25519, comb_p384.cu and comb_p521.cu inside p384
// and p521, each after the field's coz header and comb_scan.cuh, so the
// code is written once; the file has no include guard and includes
// nothing. The table staging and the masked scan are field-independent
// (comb_scan.cuh, namespace comb); the layout of an entry is the width's
// (comb::Layout<kWords>), and a chain has 2 D positions (nbits / 8: 32,
// 48 or 66).

constexpr int kCombPositions = 2 * kDigits;

// Entry e of a position j >= 1 staged in `buf`: +-(2m+1) 2^(8j) B, its
// magnitude m read by masks and its sign applied by a masked negation.
__device__ __forceinline__ void read_signed_entry(const uint4* buf, uint32_t e, fe& x, fe& y) {
  const uint32_t neg = e < 128u ? 1u : 0u;
  const uint32_t m = (e & 127u) ^ ((0u - neg) & 127u);
  comb::scan<comb::kHalfEntries>(buf, m, x, y);
  y = fe_select(neg, fe_neg(y), y);
}

// Entry e of position j staged in `buf`; position 0 keeps all 256 signed
// entries (the top digit is folded in). j is a loop counter, never the
// scalar.
__device__ __forceinline__ void read_entry(const uint4* buf, int j, uint32_t e, fe& x, fe& y) {
  if (j == 0) {
    comb::scan<comb::kEntries0>(buf, e, x, y);
  } else {
    read_signed_entry(buf, e, x, y);
  }
}

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

// The parity fix-up (even k computed (k + 1) B: add -B) and the store of
// lane i, if it exists.
template <bool kStrict>
__device__ __forceinline__ void comb_finish(fe x, fe y, fe z, const int32_t* scalars,
                                            const int32_t* negbase, int32_t* ax_out,
                                            int32_t* ay_out, int32_t* z_out, int64_t B, int64_t i,
                                            bool active) {
  fe sx, sy, sz;
  comb_add<kStrict>(x, y, z, fe_from_digits(negbase), fe_from_digits(negbase + kDigits), sx,
                    sy, sz);
  const uint32_t even = ((uint32_t)scalars[i] & 1u) ^ 1u;
  if (active) {
    fe_store(ax_out, B, i, fe_select(even, sx, x));
    fe_store(ay_out, B, i, fe_select(even, sy, y));
    fe_store(z_out, B, i, fe_select(even, sz, z));
  }
}

// One lane of the comb. Every thread of the block runs every position, the
// block's staging and barriers included; `active` says whether lane i
// exists, and only active lanes store.
// `buf`: two buffers of the width's largest position.
template <bool kStrict>
__device__ __forceinline__ void comb_lane(
    const int32_t* scalars, const uint4* tables, const int32_t* negbase, int32_t* ax_out,
    int32_t* ay_out, int32_t* z_out, int64_t B, int64_t i, bool active,
    uint4 (*buf)[comb::Layout<kWords>::kBufVecs]) {
  constexpr int kEV = comb::Layout<kWords>::kEntryVecs;
  fe x, y, z;
  comb::stage_position<kEV>(tables, 0, buf[0]);
#pragma unroll 1
  for (int j = 0; j < kCombPositions; ++j) {
    if (j + 1 < kCombPositions) {
      comb::stage_position<kEV>(tables, j + 1, buf[(j + 1) & 1]);
      comb::wait_staged<1>();
    } else {
      comb::wait_staged<0>();
    }
    __syncthreads();
    const uint32_t e = comb::entry_index<kDigits>(scalars, B, i, j);
    if (j == 0) {
      read_entry(buf[0], 0, e, x, y);
      z = fe_one();
    } else {
      fe ex, ey;
      read_signed_entry(buf[j & 1], e, ex, ey);
      comb_add<kStrict>(x, y, z, ex, ey, x, y, z);
    }
    __syncthreads();  // the next staging overwrites this buffer
  }
  comb_finish<kStrict>(x, y, z, scalars, negbase, ax_out, ay_out, z_out, B, i, active);
}
