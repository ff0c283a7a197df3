// Kernel J's lane, the comb's pairwise tree, over the field of the including
// namespace (sm_90a). comb_tree.cu includes this file inside namespaces
// p256, secp256k1 and w25519, each after the field's coz header,
// comb_mma.cuh, comb_lane.cuh, comb_mma_lane.cuh and the tree's
// field-independent staging (namespace tree), so the lane is
// written once; the file has no include guard and includes nothing.
// comb_tree.cu says what the kernel computes and how.

// One lane of the tree; every thread takes part in the block's staging,
// barriers and products, and only active lanes store. Step 0, the only one
// that reads position 0 (256 entries), comes before the loop, as kernel B
// reads position 0 before its own; steps 1 .. 15 read two positions of 128
// magnitudes each.
__device__ __forceinline__ void comb_tree_lane(const int32_t* scalars, const uint8_t* tables,
                                               const int32_t* negbase, int32_t* ax_out,
                                               int32_t* ay_out, int32_t* z_out, int64_t B,
                                               int64_t i, bool active, uint8_t* smem) {
  uint32_t* const rows = tree::rows(smem);
  // the pending sums, one a level, in thread-local memory (comb_tree.cu)
  fe sx[tree::kLevels], sy[tree::kLevels], sz[tree::kLevels];
  fe x, y, z;
  // step 0: the pair (0, 16) into buffer 0, step 1's pair in flight
  tree::stage_pair(tables, 0, smem);
  tree::stage_pair(tables, 1, smem);
  comb::wait_staged<1>();
  __syncthreads();
  {
    fe ax, ay, bx, by;
    read_entry_mma(tree::slot(smem, 0, 0), rows, 0, comb::entry_index(scalars, B, i, 0), ax,
                   ay);
    read_signed_entry_mma(tree::slot(smem, 0, 1), rows,
                          comb::entry_index(scalars, B, i, tree::kPairs), bx, by);
    __syncthreads();  // step 2 stages into the buffer just read
    aff_add(ax, ay, bx, by, x, y, z);  // node 0 of level 1, pending at level 0
  }
  sx[0] = x;
  sy[0] = y;
  sz[0] = z;
#pragma unroll 1
  for (int k = 1; k < tree::kPairs; ++k) {
    if (k + 1 < tree::kPairs) {
      tree::stage_pair(tables, k + 1, smem);
      comb::wait_staged<1>();
    } else {
      comb::wait_staged<0>();
    }
    __syncthreads();
    const int lo = tree::leaf(k);
    fe ax, ay, bx, by;
    read_signed_entry_mma(tree::slot(smem, k & 1, 0), rows, comb::entry_index(scalars, B, i, lo),
                          ax, ay);
    read_signed_entry_mma(tree::slot(smem, k & 1, 1), rows,
                          comb::entry_index(scalars, B, i, lo + tree::kPairs), bx, by);
    __syncthreads();  // the next step stages into the buffer just read
    aff_add(ax, ay, bx, by, x, y, z);  // node lo of level 1
    // add the pending node of each level whose bit of k is set (it has the
    // lower index), and leave the new node pending at the first clear bit
#pragma unroll 1
    for (int l = 0; l < tree::kLevels; ++l) {
      if (((k >> l) & 1) == 0) {
        sx[l] = x;
        sy[l] = y;
        sz[l] = z;
        break;
      }
      fe px = sx[l], py = sy[l], pz = sz[l], h, r;
      jac_add(px, py, pz, x, y, z, x, y, z, h, r);
    }
  }
  // k = 15 set every bit: (x, y, z) is the root
  comb_finish<false>(x, y, z, scalars, negbase, ax_out, ay_out, z_out, B, i, active);
}
