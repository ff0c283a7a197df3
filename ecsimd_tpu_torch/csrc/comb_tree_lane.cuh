// Kernel J's lane, the comb's pairwise tree, over the field of the including
// namespace (sm_90a). comb_tree.cu includes this file inside namespaces
// p256, secp256k1 and w25519, each after the field's coz header,
// comb_scan.cuh, comb_lane.cuh and the tree's field-independent staging
// and stack (namespace tree), so the lane is written once; the file has no
// include guard and includes nothing. comb_tree.cu says what the kernel
// computes and how.

// One lane of the tree; every thread takes part in the block's staging and
// barriers, and only active lanes store.
__device__ __forceinline__ void comb_tree_lane(const int32_t* scalars, const uint4* tables,
                                               const int32_t* negbase, int32_t* ax_out,
                                               int32_t* ay_out, int32_t* z_out, int64_t B,
                                               int64_t i, bool active, uint4* smem) {
  uint32_t* stack = reinterpret_cast<uint32_t*>(smem + tree::kStageVecs);
  fe x, y, z;
  tree::stage_pair(tables, 0, smem);
#pragma unroll 1
  for (int k = 0; k < tree::kPairs; ++k) {
    if (k + 1 < tree::kPairs) {
      tree::stage_pair(tables, k + 1, smem);
      comb::wait_staged<1>();
    } else {
      comb::wait_staged<0>();
    }
    __syncthreads();
    const int lo = tree::leaf(k);
    fe ax, ay, bx, by;
    read_entry(tree::slot(smem, k & 1, 0), lo, comb::entry_index(scalars, B, i, lo), ax, ay);
    read_signed_entry(tree::slot(smem, k & 1, 1),
                      comb::entry_index(scalars, B, i, lo + tree::kPairs), bx, by);
    __syncthreads();  // the next step stages into the buffer just read
    aff_add(ax, ay, bx, by, x, y, z);  // node lo of level 1
    // add the pending node of each level whose bit of k is set (it has the
    // lower index), and leave the new node pending at the first clear bit
#pragma unroll 1
    for (int l = 0; l < tree::kLevels; ++l) {
      if (((k >> l) & 1) == 0) {
        tree::stack_put(stack, l, x, y, z);
        break;
      }
      fe px, py, pz, h, r;
      tree::stack_get(stack, l, px, py, pz);
      jac_add(px, py, pz, x, y, z, x, y, z, h, r);
    }
  }
  // k = 15 set every bit: (x, y, z) is the root
  comb_finish<false>(x, y, z, scalars, negbase, ax_out, ay_out, z_out, B, i, active);
}

