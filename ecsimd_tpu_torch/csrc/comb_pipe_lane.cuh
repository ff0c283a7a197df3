// Kernel K's lane, the comb's pipelined serial chain, over the field of the
// including namespace (sm_90a). comb_pipe.cu includes this file inside
// namespaces p256, secp256k1 and w25519, comb_pipe_p384.cu and
// comb_pipe_p521.cu inside p384 and p521, each after the field's coz
// header, comb_mma.cuh, comb_lane.cuh and comb_mma_lane.cuh, so the lane is
// written once; the file has no include guard and includes nothing.
// comb_pipe.cu says what the kernel computes and how; the chain has the
// width's 2 D positions and its entries the width's layout
// (comb_mma::Layout<kWords>), as kernel B's.

// One lane of the pipelined comb; every thread takes part in the block's
// staging, barriers and products, and only active lanes store. `smem`:
// comb_mma::serial_bytes, as kernel B's — position 0's buffer (every even
// position's), the odd positions' buffer, the row buffers. Two buffers
// suffice: entry j + 1 is read into registers in step j, so position j's
// buffer is free for position j + 2 once step j - 1's closing barrier has
// passed.
__device__ __forceinline__ void comb_pipe_lane(const int32_t* scalars, const uint8_t* tables,
                                               const int32_t* negbase, int32_t* ax_out,
                                               int32_t* ay_out, int32_t* z_out, int64_t B,
                                               int64_t i, bool active, uint8_t* smem) {
  using L = comb_mma::Layout<kWords>;
  constexpr int kPos = kCombPositions;
  uint8_t* const even = smem;
  uint8_t* const odd = smem + L::kBytes0;
  uint32_t* const rows = comb_mma::warp_rows(odd + L::kBytes);
  fe x, y, z, ex, ey;
  // prologue: position 0 seeds the accumulator, position 1 is read ahead
  comb_mma::stage_position<kWords>(tables, 0, even);
  comb_mma::stage_position<kWords>(tables, 1, odd);
  comb::wait_staged<1>();
  __syncthreads();
  read_entry_mma(even, rows, 0, comb::entry_index<kDigits>(scalars, B, i, 0), x, y);
  z = fe_one();
  __syncthreads();
  comb_mma::stage_position<kWords>(tables, 2, even);
  comb::wait_staged<1>();
  __syncthreads();
  read_signed_entry_mma(odd, rows, comb::entry_index<kDigits>(scalars, B, i, 1), ex, ey);
  __syncthreads();
  // step j holds entry j in (ex, ey); position j + 1 is staged or in flight
  // in the buffer of its parity, and position j's buffer is free
#pragma unroll 1
  for (int j = 1; j < kPos; ++j) {
    fe nx = ex, ny = ey;
    if (j + 1 < kPos) {
      if (j + 2 < kPos) {
        comb_mma::stage_position<kWords>(tables, j + 2, j & 1 ? odd : even);
        comb::wait_staged<1>();
      } else {
        comb::wait_staged<0>();
      }
      __syncthreads();
      read_signed_entry_mma(j & 1 ? even : odd, rows,
                            comb::entry_index<kDigits>(scalars, B, i, j + 1), nx, ny);
    }
    add_z2_1(x, y, z, ex, ey, x, y, z);
    __syncthreads();  // the next step stages into the buffer just read
    ex = nx;
    ey = ny;
  }
  comb_finish<false>(x, y, z, scalars, negbase, ax_out, ay_out, z_out, B, i, active);
}
