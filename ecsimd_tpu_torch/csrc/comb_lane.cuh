// The comb's per-lane add and fix-up, over the field of the including
// namespace (sm_90a). Kernels B (comb.cu, comb_p384.cu, comb_p521.cu), J
// (comb_tree*.cu), K (comb_pipe*.cu) and L (comb_general*.cu) include this
// file inside namespaces p256, secp256k1, w25519, p384 and p521, each after
// the field's coz header and comb_mma.cuh, so the code is written once; the
// file has no include guard and includes nothing. A chain has 2 D
// positions (nbits / 8: 32, 48 or 66). A lane reads an entry on the tensor
// cores (comb_mma_lane.cuh).

constexpr int kCombPositions = 2 * kDigits;

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
