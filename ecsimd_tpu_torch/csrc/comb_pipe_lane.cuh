// Kernel K's lane, the comb's pipelined serial chain, over the field of the
// including namespace (sm_90a). comb_pipe.cu includes this file inside
// namespaces p256, secp256k1 and w25519, comb_pipe_p384.cu and
// comb_pipe_p521.cu inside p384 and p521, each after the field's coz
// header, comb_scan.cuh and comb_lane.cuh, so the lane is written once; the
// file has no include guard and includes nothing. comb_pipe.cu says what the
// kernel computes and how; the chain has the width's 2 D positions and its
// entries the width's layout (comb::Layout<kWords>), as kernel B's.

// One lane of the pipelined comb; every thread takes part in the block's
// staging and barriers, and only active lanes store.
// `buf`: two buffers of the width's largest position.
__device__ __forceinline__ void comb_pipe_lane(const int32_t* scalars, const uint4* tables,
                                               const int32_t* negbase, int32_t* ax_out,
                                               int32_t* ay_out, int32_t* z_out, int64_t B,
                                               int64_t i, bool active,
                                               uint4 (*buf)[comb::Layout<kWords>::kBufVecs]) {
  constexpr int kPos = kCombPositions;
  constexpr int kEV = comb::Layout<kWords>::kEntryVecs;
  fe x, y, z, ex, ey;
  // prologue: position 0 seeds the accumulator, position 1 is read ahead
  comb::stage_position<kEV>(tables, 0, buf[0]);
  comb::stage_position<kEV>(tables, 1, buf[1]);
  comb::wait_staged<1>();
  __syncthreads();
  read_entry(buf[0], 0, comb::entry_index<kDigits>(scalars, B, i, 0), x, y);
  z = fe_one();
  __syncthreads();
  comb::stage_position<kEV>(tables, 2, buf[0]);
  comb::wait_staged<1>();
  __syncthreads();
  read_signed_entry(buf[1], comb::entry_index<kDigits>(scalars, B, i, 1), ex, ey);
  __syncthreads();
  // step j holds entry j in (ex, ey); position j + 1 is staged or in flight
  // in buf[(j + 1) & 1], and buf[j & 1] is free
#pragma unroll 1
  for (int j = 1; j < kPos; ++j) {
    fe nx = ex, ny = ey;
    if (j + 1 < kPos) {
      if (j + 2 < kPos) {
        comb::stage_position<kEV>(tables, j + 2, buf[j & 1]);
        comb::wait_staged<1>();
      } else {
        comb::wait_staged<0>();
      }
      __syncthreads();
      read_signed_entry(buf[(j + 1) & 1], comb::entry_index<kDigits>(scalars, B, i, j + 1), nx,
                        ny);
    }
    add_z2_1(x, y, z, ex, ey, x, y, z);
    __syncthreads();  // the next step stages into the buffer just read
    ex = nx;
    ey = ny;
  }
  comb_finish<false>(x, y, z, scalars, negbase, ax_out, ay_out, z_out, B, i, active);
}
