// Kernel L's lane, `chains` serial chains taking `unroll` positions a
// staging step, over the field of the including namespace (sm_90a). The
// sources of kernel L include this file inside the field's namespace,
// after its coz header, comb_chains.cuh and comb_lane.cuh, so the lane is
// written once; the file has no include guard and includes nothing.
// comb_chains.cuh says what the kernel computes and how. The templated L is
// the last kernel that reads its entries by the masked scan (comb_scan.cuh);
// every other comb kernel selects them on the tensor cores
// (comb_mma_lane.cuh).

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

// One lane of kernel L; every thread takes part in the block's staging and
// barriers, and only active lanes store.
template <int kChains, int kUnroll, bool kStrict>
__device__ __forceinline__ void comb_chains_lane(const int32_t* scalars, const uint4* tables,
                                                 const int32_t* negbase, int32_t* ax_out,
                                                 int32_t* ay_out, int32_t* z_out, int64_t B,
                                                 int64_t i, bool active, uint4* smem) {
  constexpr int kG = kChains * kUnroll;
  constexpr int kSteps = comb::kPositions / kG;
  static_assert(comb::kPositions % kG == 0, "chains * unroll must divide the 32 positions");
  fe ax[kChains], ay[kChains], az[kChains];
  chains::stage_step<kChains, kUnroll>(tables, 0, smem);
#pragma unroll 1
  for (int s = 0; s < kSteps; ++s) {
    if (s + 1 < kSteps) {
      chains::stage_step<kChains, kUnroll>(tables, s + 1, smem);
      comb::wait_staged<1>();
    } else {
      comb::wait_staged<0>();
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int c = 0; c < kChains; ++c) {
        const int j = chains::position<kChains, kUnroll>(s, c, u);
        const uint4* slot = chains::slot<kG>(smem, s & 1, c * kUnroll + u);
        const uint32_t e = comb::entry_index(scalars, B, i, j);
        fe ex, ey;
        if (c == 0 && u == 0) {  // position 0 at step 0, position s * kUnroll after
          read_entry(slot, j, e, ex, ey);
        } else {
          read_signed_entry(slot, e, ex, ey);
        }
        if (s == 0 && u == 0) {  // the chain's first position seeds it
          ax[c] = ex;
          ay[c] = ey;
          az[c] = fe_one();
        } else {
          comb_add<kStrict>(ax[c], ay[c], az[c], ex, ey, ax[c], ay[c], az[c]);
        }
      }
    }
    __syncthreads();  // the next step stages into the buffer just read
  }
  // combine the chains left to right
  fe x = ax[0], y = ay[0], z = az[0];
#pragma unroll
  for (int c = 1; c < kChains; ++c) {
    fe h, r;
    jac_add(x, y, z, ax[c], ay[c], az[c], x, y, z, h, r);
  }
  comb_finish<kStrict>(x, y, z, scalars, negbase, ax_out, ay_out, z_out, B, i, active);
}
