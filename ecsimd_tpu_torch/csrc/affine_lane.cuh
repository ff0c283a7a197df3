// Kernel D's lanes, Jacobian -> affine by a Montgomery batch inversion, over
// the field of the including namespace (sm_90a). affine.cu includes this
// file inside namespaces p256, secp256k1, w25519, p384 and p521, each after
// the field's header, so the lanes are written once; the file has no
// include guard and includes nothing. affine.cu says what the kernel
// computes and what bounds it.
//
// A block of T threads converts T * G lanes: thread t takes lanes base + t +
// j T, j < G, so that for each j neighbouring threads read neighbouring
// words of a plane. The thread forms the prefix products P_j = z_0 ... z_j
// of its G z values (forward, G - 1 multiplies), inverts its total P_{G-1}
// (`Tree`: with the block's other T - 1 totals, below; else alone, fe_inv),
// then walks back: z_j^-1 = inv P_{j-1} and inv <- inv z_j, 2 multiplies a
// lane, z_j read again from device memory. A lane at infinity (z = 0) and a
// lane past the end of the batch enter the products as 1, so the product
// is never 0; the first gets z^-1 = 0 and so (0, 0), as the plain
// version's batch_inverse gives, and the second is neither read nor
// stored. Each lane's tail is the per-lane kernel's: z^-2, x z^-2, y z^-2
// z^-1, to classical residues. Every residue is canonical and the inverse
// unique, so the planes equal the plain version's word for word. No branch
// and no address depends on the data: the batch size and the thread index
// are public.

// The prefix products P_0 .. P_{G-2} of one thread live in the block's
// dynamic shared memory, word w of P_j at pre[(j N + w) T] from pre = smem +
// threadIdx.x, so that a warp's accesses fall on 32 banks and G costs no
// registers (kept in registers, the 256-bit lanes ran 1.5 times slower:
// PERF.md).
template <int T>
__device__ __forceinline__ void prefix_put(uint32_t* pre, int j, const fe& a) {
#pragma unroll
  for (int w = 0; w < kWords; ++w) pre[(j * kWords + w) * T] = a.v[w];
}

template <int T>
__device__ __forceinline__ fe prefix_get(const uint32_t* pre, int j) {
  fe a;
#pragma unroll
  for (int w = 0; w < kWords; ++w) a.v[w] = pre[(j * kWords + w) * T];
  return a;
}

// Lane i's z, or 1 where i is past the end of the batch or z = 0; `zero`
// says z = 0 (0 past the end).
__device__ __forceinline__ fe affine_z(const int32_t* zs, int64_t B, int64_t i, uint32_t& zero) {
  fe z = fe_one();
  zero = 0u;
  if (i < B) {
    const fe v = fe_load(zs, B, i);
    zero = fe_is_zero(v);
    z = fe_select(zero, z, v);
  }
  return z;
}

// r = a * (lane >= off ? b : 1), b from `off` lanes below (the block
// tree's scans).
__device__ __forceinline__ fe shfl_up_mul(const fe& a, int off, int lane) {
  fe b;
#pragma unroll
  for (int w = 0; w < kWords; ++w) b.v[w] = __shfl_up_sync(0xFFFFFFFFu, a.v[w], off);
  return fe_mul(a, fe_select(lane >= off ? 1u : 0u, b, fe_one()));
}

__device__ __forceinline__ fe shfl_down_mul(const fe& a, int off, int lane) {
  fe b;
#pragma unroll
  for (int w = 0; w < kWords; ++w) b.v[w] = __shfl_down_sync(0xFFFFFFFFu, a.v[w], off);
  return fe_mul(a, fe_select(lane + off < 32 ? 1u : 0u, b, fe_one()));
}

__device__ __forceinline__ fe shfl_fe(const fe& a, int src) {
  fe b;
#pragma unroll
  for (int w = 0; w < kWords; ++w) b.v[w] = __shfl_sync(0xFFFFFFFFu, a.v[w], src);
  return b;
}

__device__ __forceinline__ fe smem_get(const uint32_t* s, int k) {
  fe a;
#pragma unroll
  for (int w = 0; w < kWords; ++w) a.v[w] = s[k * kWords + w];
  return a;
}

__device__ __forceinline__ void smem_put(uint32_t* s, int k, const fe& a) {
#pragma unroll
  for (int w = 0; w < kWords; ++w) s[k * kWords + w] = a.v[w];
}

// The inverse of each thread's `total` through the block of T threads (W =
// T / 32 warps): in each warp, inclusive prefix and suffix products by
// shuffles (5 multiplies each); the warps' products Q_v to shared memory;
// thread 0 alone forms their prefix products, inverts the block's product
// once (fe_inv) and unwinds it into each Q_v^-1 (2 multiplies a warp),
// while the other warps wait at the barrier and issue nothing; then each
// thread's total^-1 = Q_v^-1 (t_0 .. t_{l-1}) (t_{l+1} .. t_31). Every
// thread of the block must call it.
template <int T>
__device__ __forceinline__ fe block_inverse(const fe& total) {
  constexpr int W = T / 32;
  __shared__ uint32_t q[W * kWords], qp[W * kWords];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  fe pre = total, suf = total;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    pre = shfl_up_mul(pre, off, lane);
    suf = shfl_down_mul(suf, off, lane);
  }
  if (lane == 31) smem_put(q, warp, pre);
  __syncthreads();
  if (threadIdx.x == 0) {
    fe acc = smem_get(q, 0);
#pragma unroll 1
    for (int v = 1; v < W; ++v) {
      smem_put(qp, v - 1, acc);
      acc = fe_mul(acc, smem_get(q, v));
    }
    fe inv = fe_inv(acc);
#pragma unroll 1
    for (int v = W - 1; v > 0; --v) {
      const fe qv = smem_get(q, v);
      smem_put(q, v, fe_mul(inv, smem_get(qp, v - 1)));
      inv = fe_mul(inv, qv);
    }
    smem_put(q, 0, inv);
  }
  __syncthreads();
  const fe q_inv = smem_get(q, warp);
  fe below = shfl_fe(pre, lane == 0 ? 0 : lane - 1);   // t_0 .. t_{l-1}
  fe above = shfl_fe(suf, lane == 31 ? 31 : lane + 1);  // t_{l+1} .. t_31
  below = fe_select(lane == 0 ? 1u : 0u, fe_one(), below);
  above = fe_select(lane == 31 ? 1u : 0u, fe_one(), above);
  return fe_mul(fe_mul(q_inv, below), above);
}

// One lane's tail: x z^-2 and y z^-3 as classical residues, (0, 0) at
// infinity, from z^-1 (or 1 at infinity).
__device__ __forceinline__ void affine_tail(const int32_t* xs, const int32_t* ys, int32_t* ax,
                                            int32_t* ay, int64_t B, int64_t i, fe zi,
                                            uint32_t zero) {
  zi = fe_select(zero, fe_zero(), zi);
  const fe zi2 = fe_sqr(zi);
  fe_store(ax, B, i, fe_to_classical(fe_mul(fe_load(xs, B, i), zi2)));
  fe_store(ay, B, i, fe_to_classical(fe_mul(fe_mul(fe_load(ys, B, i), zi2), zi)));
}

// The G lanes of this thread (block of T threads from lane base; `smem` the
// block's dynamic shared memory, (G - 1) N T words). With `Tree`, every
// thread of the block must call it (lanes past the end included).
template <int G, bool Tree, int T>
__device__ __forceinline__ void affine_group(const int32_t* xs, const int32_t* ys,
                                             const int32_t* zs, int32_t* ax, int32_t* ay,
                                             int64_t B, int64_t base, uint32_t* smem) {
  uint32_t* pre = smem + threadIdx.x;
  const int64_t first = base + threadIdx.x;
  uint32_t zero;
  fe acc = affine_z(zs, B, first, zero);
#pragma unroll
  for (int j = 1; j < G; ++j) {
    prefix_put<T>(pre, j - 1, acc);
    acc = fe_mul(acc, affine_z(zs, B, first + (int64_t)j * T, zero));
  }
  fe inv;
  if constexpr (Tree) {
    inv = block_inverse<T>(acc);
  } else {
    inv = fe_inv(acc);
  }
#pragma unroll
  for (int j = G - 1; j > 0; --j) {
    const int64_t i = first + (int64_t)j * T;
    const fe zi = fe_mul(inv, prefix_get<T>(pre, j - 1));
    inv = fe_mul(inv, affine_z(zs, B, i, zero));
    if (i < B) affine_tail(xs, ys, ax, ay, B, i, zi, zero);
  }
  affine_z(zs, B, first, zero);
  if (first < B) affine_tail(xs, ys, ax, ay, B, first, inv, zero);
}
