// Kernel M's lane and tree, the batch reduction tree of multi-scalar
// multiplication, over the field of the including namespace (sm_90a).
// batch_sum.cu includes this file inside namespaces p256, secp256k1 and
// w25519, batch_sum_p384.cu and batch_sum_p521.cu inside p384 and p521, each
// after batch_sum_kernel.cuh (cooperative_groups) and the curve's coz header
// (the field's fe_* arithmetic, kWords, kDigits, the curve's jac_dbl and
// jacobian.cuh's jac_add), so the lane and the tree are written once; the
// file has no include guard and includes nothing.
//
// Replaces ecsimd_tpu/curves/group.py:batch_sum (plain XLA, no Pallas
// kernel); plain twin: curves/group.py batch_sum in this package. Each
// level adds lane i to lane i + h (h = n / 2) with the complete add and
// carries an odd last lane, as the JAX package's loop does, so the tree,
// and with it the output's Jacobian representative, is the same.

// The exception-free Jacobian add of ecsimd_tpu/curves/group.py:
// jac_add_complete, select for select: P1 == P2 (h == 0, r == 0) ->
// jac_dbl(P1); P1 == -P2 (h == 0, r != 0) -> z = 0; P1 at infinity (z1 == 0)
// -> (x2, y2, z2); P2 at infinity -> (x1, y1, z1). Either operand may be at
// infinity (jacobian.cuh's add_complete takes P2 finite and returns z = 1
// where P1 is at infinity). jac_dbl is the curve's own doubling: dbl-2001-b
// on the a = -3 curves and the a = 0 form on secp256k1 are the general-a
// formula of the JAX package (M = 3 X^2 + a Z^4) as polynomials, so they
// give its residues on every input, z = 0 included. Both the add and the
// doubling are always computed: the time does not depend on the case.
__device__ __forceinline__ void add_complete_any(fe x1, fe y1, fe z1, fe x2, fe y2, fe z2,
                                                 fe& x3, fe& y3, fe& z3) {
  const uint32_t inf1 = fe_is_zero(z1);
  const uint32_t inf2 = fe_is_zero(z2);
  fe ax, ay, az, dx, dy, dz;
  uint32_t hz, rz;
  {
    fe h, r;
    jac_add(x1, y1, z1, x2, y2, z2, ax, ay, az, h, r);
    hz = fe_is_zero(h);
    rz = fe_is_zero(r);
  }
  jac_dbl(x1, y1, z1, dx, dy, dz);
  const uint32_t finite = (inf1 ^ 1u) & (inf2 ^ 1u);
  const uint32_t same = hz & rz & finite;
  const uint32_t opp = hz & (rz ^ 1u) & finite;
  ax = fe_select(same, dx, ax);
  ay = fe_select(same, dy, ay);
  az = fe_select(same, dz, fe_select(opp, fe_zero(), az));
  x3 = fe_select(inf1, x2, fe_select(inf2, x1, ax));
  y3 = fe_select(inf1, y2, fe_select(inf2, y1, ay));
  z3 = fe_select(inf1, z2, fe_select(inf2, z1, az));
}

// Output lane i of a level over n input lanes (internal-form (D, n) planes
// in, (D, (n + 1) / 2) planes out): lane i + lane i + n / 2 for i < n / 2;
// for odd n, lane n / 2 of the output is the input's last lane.
__device__ __forceinline__ void batch_sum_lane(const int32_t* xs, const int32_t* ys,
                                               const int32_t* zs, int32_t* ox, int32_t* oy,
                                               int32_t* oz, int64_t n, int64_t i) {
  const int64_t h = n / 2;
  const int64_t m = n - h;  // the output's lanes
  if (i < h) {
    fe x, y, z;
    add_complete_any(fe_load(xs, n, i), fe_load(ys, n, i), fe_load(zs, n, i),
                     fe_load(xs, n, i + h), fe_load(ys, n, i + h), fe_load(zs, n, i + h),
                     x, y, z);
    fe_store(ox, m, i, x);
    fe_store(oy, m, i, y);
    fe_store(oz, m, i, z);
  } else {  // i == h < m: the odd tail, carried
    fe_store(ox, m, i, fe_load(xs, n, n - 1));
    fe_store(oy, m, i, fe_load(ys, n, n - 1));
    fe_store(oz, m, i, fe_load(zs, n, n - 1));
  }
}

// Word w of coordinate c of lane i of block 0's shared tail buffer,
// s[c][w][i]: consecutive lanes in consecutive banks.
__device__ __forceinline__ fe tail_load(const uint32_t (*s)[::batch_sum::kThreads], int64_t i) {
  fe r;
#pragma unroll
  for (int w = 0; w < kWords; ++w) r.v[w] = s[w][i];
  return r;
}

__device__ __forceinline__ void tail_store(uint32_t (*s)[::batch_sum::kThreads], int64_t i,
                                           const fe& a) {
#pragma unroll
  for (int w = 0; w < kWords; ++w) s[w][i] = a.v[w];
}

// Block 0's levels `level` .. levels - 1 over the m lanes of ix, iy, iz
// (m <= 2 kThreads) with its lanes in shared memory, in place: thread t
// reads its operands (lanes t and t + m / 2, or the carried last lane),
// the block syncs, thread t writes output lane t, the block syncs; the
// first level reads ix, iy, iz, the last writes ox, oy, oz. Its own call
// site of the complete add.
__device__ __forceinline__ void batch_sum_block_shared(const int32_t* ix, const int32_t* iy,
                                                       const int32_t* iz, int32_t* ox,
                                                       int32_t* oy, int32_t* oz, int64_t m,
                                                       int64_t level, int64_t levels) {
  constexpr int kThreads = ::batch_sum::kThreads;
  static_assert(3 * kWords * kThreads * 4 <= 48 * 1024,
                "the block tail's buffer must fit static shared memory");
  __shared__ uint32_t tail[3][kWords][kThreads];
  const int t = threadIdx.x;
  for (bool first = true; level < levels; ++level, first = false) {
    const int64_t h = m / 2, out = m - h;
    fe x, y, z;
    if (t < out) {
      const int64_t j = t < h ? t : m - 1;  // t == h: the odd tail, carried
      if (first) {
        x = fe_load(ix, m, j);
        y = fe_load(iy, m, j);
        z = fe_load(iz, m, j);
      } else {
        x = tail_load(tail[0], j);
        y = tail_load(tail[1], j);
        z = tail_load(tail[2], j);
      }
      if (t < h) {
        fe x2, y2, z2;
        if (first) {
          x2 = fe_load(ix, m, t + h);
          y2 = fe_load(iy, m, t + h);
          z2 = fe_load(iz, m, t + h);
        } else {
          x2 = tail_load(tail[0], t + h);
          y2 = tail_load(tail[1], t + h);
          z2 = tail_load(tail[2], t + h);
        }
        add_complete_any(x, y, z, x2, y2, z2, x, y, z);
      }
    }
    __syncthreads();  // every operand read before any lane is overwritten
    if (t < out) {
      if (level + 1 == levels) {
        fe_store(ox, out, t, x);
        fe_store(oy, out, t, y);
        fe_store(oz, out, t, z);
      } else {
        tail_store(tail[0], t, x);
        tail_store(tail[1], t, y);
        tail_store(tail[2], t, z);
      }
    }
    __syncthreads();
    m = out;
  }
}

// The first `levels` levels of the tree over n lanes (1 <= levels <=
// ceil(log2 n)) in one cooperative launch of kThreads-thread blocks
// (batch_sum_kernel.cuh), the last level's lanes written to ox, oy, oz.
// While a level's output has more lanes than a block has threads, every
// block walks them with a grid-stride loop through batch_sum_lane and the
// grid syncs after it; the levels ping-pong between the two buffers of
// `scratch` (level L writes buffer L % 2: buffer 0 holds ceil(n / 2)
// lanes, buffer 1 half of that). A grid level hands its lanes out a warp's
// 32 at a time, round robin over the blocks (32-lane chunk c to block
// c % gridDim.x), so that a level of a few thousand lanes spreads over
// every SM, a warp or two on each, where contiguous chunks would stack the
// first blocks' warps on fewer SMs and slow each lane's chain of dependent
// instructions. From the first level whose output fits one block, block 0
// alone finishes the tree (the others return), thread t writing lane t:
// with kSharedTail, in shared memory (batch_sum_block_shared, a second
// inlined add); otherwise in the same loop, the levels separated by
// __syncthreads and their lanes in the scratch, in L2, so that one call
// site of the add serves both phases. The shared tail is the faster where
// its second add does not spill (P-256, Wei25519); the scratch elsewhere
// (PERF.md). Only n, levels and the lane index steer control flow and
// addresses.
template <bool kSharedTail>
__device__ __forceinline__ void batch_sum_tree(const int32_t* xs, const int32_t* ys,
                                               const int32_t* zs, int32_t* ox, int32_t* oy,
                                               int32_t* oz, int32_t* scratch, int64_t n,
                                               int64_t levels) {
  constexpr int kThreads = ::batch_sum::kThreads;
  static_assert(kThreads % 32 == 0, "whole warps");
  int32_t* const buf[2] = {scratch, scratch + 3 * kDigits * (n - n / 2)};
  const int32_t *ix = xs, *iy = ys, *iz = zs;
  const int64_t spread = ((int64_t)(threadIdx.x / 32) * gridDim.x + blockIdx.x) * 32 +
                         threadIdx.x % 32;
  int64_t m = n, level = 0;
  for (; level < levels; ++level) {
    const bool grid = m > 2 * kThreads;
    if (!grid && (kSharedTail || blockIdx.x != 0)) break;
    const int64_t out = m - m / 2;
    int32_t *px = ox, *py = oy, *pz = oz;
    if (level + 1 < levels) {
      px = buf[level & 1];
      py = px + kDigits * out;
      pz = py + kDigits * out;
    }
    const int64_t step = grid ? (int64_t)gridDim.x * kThreads : kThreads;
    for (int64_t i = grid ? spread : threadIdx.x; i < out; i += step)
      batch_sum_lane(ix, iy, iz, px, py, pz, m, i);
    ix = px;
    iy = py;
    iz = pz;
    m = out;
    if (level + 1 < levels) {
      if (grid) {
        cooperative_groups::this_grid().sync();
      } else {
        __syncthreads();
      }
    }
  }
  if constexpr (kSharedTail) {
    if (level < levels && blockIdx.x == 0)
      batch_sum_block_shared(ix, iy, iz, ox, oy, oz, m, level, levels);
  }
}
