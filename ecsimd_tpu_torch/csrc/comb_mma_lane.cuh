// The comb's entry read on the tensor cores and kernel B's per-lane chain,
// over the field of the including namespace (sm_90a). comb.cu,
// comb_p384.cu, comb_p521.cu and the generic kernel L's sources include
// this file inside the field's namespace, after its coz header,
// comb_mma.cuh and comb_lane.cuh (comb_add, comb_finish), so the code is
// written once; the file has no include guard and includes nothing.
// comb_mma.cuh says how an entry is selected and why that is constant-time.

// Entry e of a position j >= 1 staged at `buf`: +-(2m+1) 2^(8j) B, its
// magnitude m selected by the warp's one-hot product and its sign applied
// by a masked negation. Every lane of the warp calls it together.
__device__ __forceinline__ void read_signed_entry_mma(const uint8_t* buf, uint32_t* rows,
                                                      uint32_t e, fe& x, fe& y) {
  const uint32_t neg = e < 128u ? 1u : 0u;
  const uint32_t m = (e & 127u) ^ ((0u - neg) & 127u);
  comb_mma::select<kWords, comb::kHalfEntries / 32>(buf, m, rows, x, y);
  y = fe_select(neg, fe_neg(y), y);
}

// Entry e of position j staged at `buf`; position 0 keeps all 256 signed
// entries (the top digit is folded in). j is a loop counter, never the
// scalar.
__device__ __forceinline__ void read_entry_mma(const uint8_t* buf, uint32_t* rows, int j,
                                               uint32_t e, fe& x, fe& y) {
  if (j == 0) {
    comb_mma::select<kWords, comb::kEntries0 / 32>(buf, e, rows, x, y);
  } else {
    read_signed_entry_mma(buf, rows, e, x, y);
  }
}

// One lane of kernel B. Every thread of the block runs every position, the
// block's staging, barriers and products included; `active` says whether
// lane i exists, and only active lanes store. `smem`: comb_mma::serial_bytes
// — position 0's buffer (every even position's), the odd positions'
// buffer, the row buffers.
template <bool kStrict>
__device__ __forceinline__ void comb_mma_lane(const int32_t* scalars, const uint8_t* tables,
                                              const int32_t* negbase, int32_t* ax_out,
                                              int32_t* ay_out, int32_t* z_out, int64_t B,
                                              int64_t i, bool active, uint8_t* smem) {
  using L = comb_mma::Layout<kWords>;
  uint8_t* const even = smem;
  uint8_t* const odd = smem + L::kBytes0;
  uint32_t* const rows = comb_mma::warp_rows(odd + L::kBytes);
  fe x, y, z;
  // position 0 seeds the chain (z = 1); position 1 is in flight meanwhile
  comb_mma::stage_position<kWords>(tables, 0, even);
  comb_mma::stage_position<kWords>(tables, 1, odd);
  comb::wait_staged<1>();
  __syncthreads();
  read_entry_mma(even, rows, 0, comb::entry_index<kDigits>(scalars, B, i, 0), x, y);
  z = fe_one();
  __syncthreads();  // position 2 overwrites this buffer
#pragma unroll 1
  for (int j = 1; j < kCombPositions; ++j) {
    if (j + 1 < kCombPositions) {
      comb_mma::stage_position<kWords>(tables, j + 1, (j + 1) & 1 ? odd : even);
      comb::wait_staged<1>();
    } else {
      comb::wait_staged<0>();
    }
    __syncthreads();
    const uint32_t e = comb::entry_index<kDigits>(scalars, B, i, j);
    fe ex, ey;
    read_signed_entry_mma(j & 1 ? odd : even, rows, e, ex, ey);
    comb_add<kStrict>(x, y, z, ex, ey, x, y, z);
    __syncthreads();  // the next staging overwrites this buffer
  }
  comb_finish<kStrict>(x, y, z, scalars, negbase, ax_out, ay_out, z_out, B, i, active);
}
