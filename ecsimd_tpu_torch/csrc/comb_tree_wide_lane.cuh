// Kernel J's lane on P-384 and P-521, the comb's stride tree walked by the
// schedule table, over the field of the including namespace (sm_90a).
// comb_tree_p384.cu and comb_tree_p521.cu include this file inside p384 and
// p521, each after the field's coz header, comb_tree_wide.cuh,
// comb_lane.cuh and comb_mma_lane.cuh, so the lane is written once; the
// file has no include guard and includes nothing. comb_tree_wide.cuh says
// what the kernel computes and how.

// One lane of the tree; every thread takes part in the block's staging,
// barriers and products, and only active lanes store. Step 0, the pair (0,
// npos / 2) and the only step that reads position 0 (256 entries), comes
// before the loop; steps 1 .. kSteps - 1 read two positions of 128
// magnitudes each.
__device__ __forceinline__ void comb_tree_wide_lane(const int32_t* scalars, const uint8_t* tables,
                                                    const int32_t* negbase, int32_t* ax_out,
                                                    int32_t* ay_out, int32_t* z_out, int64_t B,
                                                    int64_t i, bool active, uint8_t* smem) {
  using Sched = tree_schedule::Schedule<kCombPositions>;
  constexpr int kHalf = kCombPositions / 2;
  // the pending sums, in thread-local memory (comb_tree_wide.cuh says why);
  // `top` counts them and is set by the schedule alone
  fe sx[Sched::kPending], sy[Sched::kPending], sz[Sched::kPending];
  uint32_t* const rows = tree_wide::rows<kWords>(smem);
  fe x, y, z;
  // step 0 into buffer 0, step 1 in flight
  tree_wide::stage_pair<kWords, kCombPositions>(tables, 0, smem);
  tree_wide::stage_pair<kWords, kCombPositions>(tables, 1, smem);
  comb::wait_staged<1>();
  __syncthreads();
  {
    fe ax, ay, bx, by;
    read_entry_mma(tree_wide::slot<kWords>(smem, 0, 0), rows, 0,
                   comb::entry_index<kDigits>(scalars, B, i, 0), ax, ay);
    read_signed_entry_mma(tree_wide::slot<kWords>(smem, 0, 1), rows,
                          comb::entry_index<kDigits>(scalars, B, i, kHalf), bx, by);
    __syncthreads();  // step 2 stages into the buffer just read
    aff_add(ax, ay, bx, by, x, y, z);  // node 0 of level 1, the first pending sum
  }
  sx[0] = x;
  sy[0] = y;
  sz[0] = z;
  int top = 1;
#pragma unroll 1
  for (int k = 1; k < Sched::kSteps; ++k) {
    if (k + 1 < Sched::kSteps) {
      tree_wide::stage_pair<kWords, kCombPositions>(tables, k + 1, smem);
      comb::wait_staged<1>();
    } else {
      comb::wait_staged<0>();
    }
    __syncthreads();
    const uint32_t step = Sched::step(k);
    const int lo = (int)(step & 0xFFu);
    fe ax, ay, bx, by;
    read_signed_entry_mma(tree_wide::slot<kWords>(smem, k & 1, 0), rows,
                          comb::entry_index<kDigits>(scalars, B, i, lo), ax, ay);
    read_signed_entry_mma(tree_wide::slot<kWords>(smem, k & 1, 1), rows,
                          comb::entry_index<kDigits>(scalars, B, i, lo + kHalf), bx, by);
    __syncthreads();  // the next step stages into the buffer just read
    aff_add(ax, ay, bx, by, x, y, z);  // node lo of level 1
    // fold the pending sums the schedule says, the most recent first (each
    // the lower-index node), then leave the new node pending unless it is
    // the root
#pragma unroll 1
    for (int f = (int)(step >> 8); f > 0; --f) {
      --top;
      fe h, r;
      jac_add(sx[top], sy[top], sz[top], x, y, z, x, y, z, h, r);
    }
    if (k + 1 < Sched::kSteps) {
      sx[top] = x;
      sy[top] = y;
      sz[top] = z;
      ++top;
    }
  }
  comb_finish<false>(x, y, z, scalars, negbase, ax_out, ay_out, z_out, B, i, active);
}
