// The generic kernel L's lane, the comb's chains walked in kernel B's order
// with a running total, over the field of the including namespace (sm_90a).
// comb_general.cu and comb_general_<tag>.cu include this file inside the
// field's namespace, after its coz header, comb_general.cuh, comb_lane.cuh
// and comb_mma_lane.cuh, so the lane is written once; the file has no include
// guard and includes nothing. comb_general.cuh says what the kernel
// computes and how.

// One lane of the generic kernel L: chains of `per` positions, `group`
// positions staged a step. Every thread takes part in the block's staging
// and barriers, and only active lanes store.
template <bool kStrict>
__device__ __forceinline__ void comb_general_lane(const int32_t* scalars, const uint8_t* tables,
                                                  const int32_t* negbase, int32_t* ax_out,
                                                  int32_t* ay_out, int32_t* z_out, int64_t B,
                                                  int64_t i, bool active, uint8_t* smem, int per,
                                                  int group) {
  uint32_t* const rows = general::rows<kWords>(smem, group);
  const int steps = kCombPositions / group;
  fe x, y, z;                                  // the running chain
  fe tx = fe_zero(), ty = fe_zero(), tz = fe_zero();  // the total of the chains before it
  // step 0, and step 1 in flight meanwhile; position 0 seeds the first chain
  general::stage_step<kWords>(tables, 0, group, smem);
  if (steps > 1) {
    general::stage_step<kWords>(tables, 1, group, smem);
    comb::wait_staged<1>();
  } else {
    comb::wait_staged<0>();
  }
  __syncthreads();
  read_entry_mma(general::slot<kWords>(smem, 0, 0, group), rows, 0,
                 comb::entry_index<kDigits>(scalars, B, i, 0), x, y);
  z = fe_one();
  int left = per - 1;  // positions left in the running chain
#pragma unroll 1
  for (int s = 0; s < steps; ++s) {
    if (s > 0) {  // step s was staged during step s - 1
      if (s + 1 < steps) {
        general::stage_step<kWords>(tables, s + 1, group, smem);
        comb::wait_staged<1>();
      } else {
        comb::wait_staged<0>();
      }
      __syncthreads();
    }
#pragma unroll 1
    for (int q = s == 0 ? 1 : 0; q < group; ++q) {
      const int j = s * group + q;
      fe ex, ey;
      read_signed_entry_mma(general::slot<kWords>(smem, s & 1, q, group), rows,
                            comb::entry_index<kDigits>(scalars, B, i, j), ex, ey);
      if (left == 0) {  // the first position of a chain: fold the last one, reseed
        if constexpr (!kStrict) {
          if (j == per) {
            tx = x;
            ty = y;
            tz = z;
          } else {
            fe h, r;
            jac_add(tx, ty, tz, x, y, z, tx, ty, tz, h, r);
          }
        }
        x = ex;
        y = ey;
        z = fe_one();
        left = per;
      } else {
        comb_add<kStrict>(x, y, z, ex, ey, x, y, z);
      }
      --left;
    }
    __syncthreads();  // the next step stages into the buffer just read
  }
  if constexpr (!kStrict) {
    if (per < kCombPositions) {  // more than one chain: fold the last one
      fe h, r;
      jac_add(tx, ty, tz, x, y, z, x, y, z, h, r);
    }
  }
  comb_finish<kStrict>(x, y, z, scalars, negbase, ax_out, ay_out, z_out, B, i, active);
}
