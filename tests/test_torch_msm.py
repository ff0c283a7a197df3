"""Multi-scalar multiplication in the port: the plain batch sum (kernel M's
plain version), the shared-scalar ladder, and ``api.multi_scalar_mult``.

``group.batch_sum`` meets the JAX package's ``group.batch_sum`` word for word
on the toy curve TOY64E (three batches of 2 and 3 lanes: an equal pair, an
opposite pair, lanes at z = 0 with arbitrary x and y, odd tails), and the
JAX package's int formulas (``ow._jac_add``, ``ow._jac_dbl``) under the
selects of its ``jac_add_complete``, in its tree's order
(``_batch_sum_ints``), on TOY64E, P-256 (16 lanes) and Wei25519 (its point
of order 2 in the batch). The JAX package's own batch sum is not run at 256
bits here: eagerly one level of it takes ~13 s on a CPU at a new shape.
``api.scalar_mult_shared`` meets the JAX package's Python-int co-Z ladder
(``ecsimd_tpu/oracle/coz.py``, whose Jacobian triples are the JAX ladder's,
``test_torch_ladder.py``; the jitted JAX ladder compiles ~15 s even on
TOY64E) on TOY64E and P-256, for k in {1, 2, n - 1, n, 2^nbits - 1, a random
k, 2^nbits + 3}, and ``group.scalar_mult_shared`` meets it on TOYGLV.
``multi_scalar_mult`` meets a Python-int MSM on TOY64E (strict window) and
TOYGLV (strict GLV). Inputs from
numpy.random.default_rng(seed). Tolerance: exact."""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecsimd_tpu.curves import group as jgroup
from ecsimd_tpu.curves.point import JacobianPoint as JJacobian
from ecsimd_tpu.field import GFp as JGFp
from ecsimd_tpu.oracle import coz as ocoz
from ecsimd_tpu.oracle import window as ow
from ecsimd_tpu.specs import P256, WEI25519
from ecsimd_tpu_torch import api
from ecsimd_tpu_torch.curves import group
from ecsimd_tpu_torch.curves.point import AffinePoint, JacobianPoint
from ecsimd_tpu_torch.field import GFp
from ecsimd_tpu_torch.kernels import affine
from ecsimd_tpu_torch.kernels import batch_sum as kbs
from ecsimd_tpu_torch.kernels import ladder
from tests.toy import TOY64, TOY64E, TOYGLV
from tests.torch_helpers import ints, multiples, planes, port_spec, tplanes

ROOT = Path(__file__).resolve().parents[1]
MONTGOMERY_A = 486662  # Curve25519's A: Wei25519's x = u + A / 3


def _add_complete_ref(p1, p2, curve):
    """``ecsimd_tpu/curves/group.py:jac_add_complete``'s selects, in its order,
    over the JAX package's int formulas: ``ow._jac_add`` (add-2007-bl; it
    raises where h == 0) and ``ow._jac_dbl`` (the general-a doubling of
    ``group.jac_dbl``). Where P1 == -P2 the JAX package keeps the add's x3
    and y3 beside z3 = 0; that representative is (None, None, 0) here, so a
    tree that lets it reach the output fails the comparison (TOY64E holds it
    to the JAX package's own tree)."""
    if p1[2] % curve.p == 0:
        return p2
    if p2[2] % curve.p == 0:
        return p1
    try:
        return ow._jac_add(p1, p2, curve)
    except ZeroDivisionError:
        if ocoz.jacobian_to_affine(p1, curve) == ocoz.jacobian_to_affine(p2, curve):
            return ow._jac_dbl(p1, curve)
        return (None, None, 0)


def _batch_sum_ints(lanes, curve):
    """The JAX package's tree: lane i + lane i + n // 2, an odd last lane
    carried, until one lane is left."""
    while len(lanes) > 1:
        h = len(lanes) // 2
        lanes = [_add_complete_ref(lanes[i], lanes[i + h], curve)
                 for i in range(h)] + lanes[2 * h:]
    return lanes[0]


def _jacobian(rng, curve, pt):
    """Affine (x, y) ints -> (x z^2, y z^3, z) with a random z != 0."""
    p = curve.p
    z = int(rng.integers(2, 1 << 62)) % p or 1
    return (pt[0] * z * z % p, pt[1] * z ** 3 % p, z)


def _batch(rng, curve, n):
    """n Jacobian lanes: lanes 0 and n // 2 equal (other z), 1 and n // 2 + 1
    opposite, 2 and n - 1 at z = 0 with arbitrary x and y (P1 and P2 at
    infinity at the first level), the rest random multiples of G."""
    p, h = curve.p, n // 2
    pts = multiples(curve, 3 * n)[::3]
    lanes = [_jacobian(rng, curve, q) for q in pts[:n]]
    lanes[h] = _jacobian(rng, curve, pts[0])
    lanes[h + 1] = _jacobian(rng, curve, (pts[1][0], (p - pts[1][1]) % p))
    lanes[2] = (int(rng.integers(0, 1 << 62)) % p, int(rng.integers(0, 1 << 62)) % p, 0)
    lanes[n - 1] = (int(rng.integers(0, 1 << 62)) % p, 5 % p, 0)
    return lanes


def _port_jacobian(lanes, curve):
    """Jacobian int triples (classical values) -> the port's internal-form
    JacobianPoint on the CPU."""
    tc, d = port_spec(curve), curve.field.ndigits
    coords = [GFp.from_classical(tplanes([t[j] for t in lanes], d), tc.field) for j in range(3)]
    return JacobianPoint(*coords, tc)


def _triples(pt: JacobianPoint):
    """A port JacobianPoint -> classical int triples."""
    return list(zip(*(ints(c.to_classical()) for c in (pt.x, pt.y, pt.z))))


def _toy_batches(rng):
    """TOY64E batches of 2 and 3 lanes, so that every level of the JAX tree
    adds one lane pair (one eager shape): [P, P with another z, inf] (P1 ==
    P2, then P2 at infinity and the odd tail), [inf, Q, -Q] (P1 at
    infinity, then P1 == -P2: the output is the JAX package's representative
    of infinity), [inf, inf] (both operands at infinity); x and y at z = 0
    arbitrary."""
    c, p = TOY64E, TOY64E.p
    (px, py), (qx, qy) = multiples(c, 5)[3:5]
    junk = lambda: (int(rng.integers(0, 1 << 62)) % p, int(rng.integers(0, 1 << 62)) % p, 0)  # noqa: E731
    return [
        [_jacobian(rng, c, (px, py)), _jacobian(rng, c, (px, py)), junk()],
        [junk(), _jacobian(rng, c, (qx, qy)), _jacobian(rng, c, (qx, (p - qy) % p))],
        [junk(), junk()],
    ]


def test_batch_sum_toy64e_matches_jax():
    d, fs = TOY64E.field.ndigits, TOY64E.field
    for lanes in _toy_batches(np.random.default_rng(150)):
        port = group.batch_sum(_port_jacobian(lanes, TOY64E))
        jpt = JJacobian(*(JGFp.from_classical(jnp.asarray(planes([t[j] for t in lanes], d)), fs)
                          for j in range(3)), TOY64E)
        ref = jgroup.batch_sum(jpt)
        for t, j in ((port.x, ref.x), (port.y, ref.y), (port.z, ref.z)):
            assert t.planes.shape == (d, 1)
            np.testing.assert_array_equal(t.planes.numpy(), np.asarray(j.planes))
        want = _batch_sum_ints(lanes, TOY64E)
        if want[0] is None:  # P1 == -P2: z = 0, the representative is JAX's
            assert ints(port.z.planes) == [0]
        else:
            assert _triples(port) == [want]
        # kernel M's wrapper takes the plain route on CPU tensors
        assert _triples(kbs.batch_sum(_port_jacobian(lanes, TOY64E))) == _triples(port)


def _order2_w25519():
    x = MONTGOMERY_A * pow(3, -1, WEI25519.p) % WEI25519.p
    assert (x ** 3 + WEI25519.a * x + WEI25519.b) % WEI25519.p == 0
    return (x, 0, 1)


@pytest.mark.parametrize("curve", [P256, WEI25519], ids=lambda c: c.name)
def test_batch_sum_256_matches_the_jax_tree_on_ints(curve):
    rng = np.random.default_rng(151)
    lanes = _batch(rng, curve, 16)
    if curve is WEI25519:
        lanes[5] = _order2_w25519()
    assert _triples(group.batch_sum(_port_jacobian(lanes, curve))) == [
        _batch_sum_ints(lanes, curve)]


def test_batch_sum_w25519_doubles_its_point_of_order_2():
    """T + T with T of order 2: the general-a doubling's (x, y) at z = 0,
    the JAX package's representative; then T + inf = T and inf + T = T."""
    t = _order2_w25519()
    tw = (t[0] * 4 % WEI25519.p, 0, 2)  # T with z = 2
    for lanes in ([t, tw], [t, tw, (0, 0, 0)], [(3, 4, 0), t]):
        got = _triples(group.batch_sum(_port_jacobian(lanes, WEI25519)))
        assert got == [_batch_sum_ints(lanes, WEI25519)]
    dbl = _triples(group.batch_sum(_port_jacobian([t, tw], WEI25519)))[0]
    assert dbl[2] == 0 and dbl == ow._jac_dbl(t, WEI25519)


def test_kernel_m_doubling_is_the_general_a_formula():
    """Kernel M doubles with each curve's own jac_dbl: dbl-2001-b on the
    a = -3 curves (plain twin ``group.dbl_am3``), the general-a formula
    elsewhere (``group.jac_dbl``). Both give the general-a residues on any
    input, z = 0 and y = 0 included."""
    rng = np.random.default_rng(152)
    p = P256.p
    vals = [int.from_bytes(rng.bytes(40), "little") % p for _ in range(24)]
    trip = [vals[0:8], vals[8:16], [0, 0, 1, 5] + vals[20:24]]
    trip[1][3] = 0
    tc = port_spec(P256)
    x, y, z = (GFp(tplanes(v, 16), tc.field) for v in trip)
    got = group.dbl_am3(x, y, z, tc)
    want = group.jac_dbl(x, y, z, tc)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.planes.numpy(), w.planes.numpy())
    assert list(zip(*(ints(w.planes) for w in want))) == [
        ow._jac_dbl(q, P256) for q in zip(*trip)]


def _ladder_affine(k, pt, curve):
    """The JAX package's co-Z ladder on Python ints (its Jacobian triples
    are the JAX ladder's), as affine ints, (0, 0) at z = 0."""
    w = ocoz.scalar_mult(k, (*pt, 1), curve)
    return ocoz.jacobian_to_affine(w, curve) if w[2] % curve.p else (0, 0)


@pytest.mark.parametrize("curve", [TOY64E, P256], ids=lambda c: c.name)
def test_scalar_mult_shared_at_the_edge_scalars(curve):
    """k in {1, 2, n - 1, n, 2^nbits - 1, a random k, 2^nbits + 3}: the
    planes of k mod 2^nbits, and the ladder on them in one batched call (one
    k a lane: ``ladder.scalar_mult``, kernel A's wrapper) against the JAX
    package's int ladder, Jacobian triples word for word; the entry point itself
    on TOY64E at 2^nbits + 3, past the planes' range (the plain ladder takes
    ~1 s a call on TOY64E, ~8 s on P-256)."""
    tc, d = port_spec(curve), curve.field.ndigits
    n, top = curve.order, (1 << curve.field.nbits) - 1
    k_rand = int.from_bytes(np.random.default_rng(153).bytes(40), "little") % n
    ks = [1, 2, n - 1, n, top, k_rand, top + 4]
    planes_k = torch.cat([api.shared_scalar_planes(k, tc, 1, "cpu") for k in ks], dim=1)
    assert ints(planes_k) == [k % (1 << curve.field.nbits) for k in ks]
    assert ints(api.shared_scalar_planes(top + 5, tc, 3, "cpu")) == [4] * 3
    got = ladder.scalar_mult(planes_k, api.generator_batch(tc, len(ks), device="cpu"))
    assert _triples(got) == [ocoz.scalar_mult(k, (curve.gx, curve.gy, 1), curve) for k in ks]
    if curve is not TOY64E:
        return
    pts = multiples(curve, 3)
    tpts = AffinePoint(tplanes([x for x, _ in pts], d), tplanes([y for _, y in pts], d), tc)
    one = api.scalar_mult_shared(top + 4, tpts)
    assert list(zip(ints(one.x), ints(one.y))) == [_ladder_affine(top + 4, q, curve) for q in pts]


def test_group_scalar_mult_shared_takes_the_jax_bit_vector():
    """The plain Jacobian ladder on the JAX package's (nbits,) bit vector of
    a random k, on TOYGLV (32 bits, the cheapest ladder), against the JAX
    package's int ladder."""
    curve, d = TOYGLV, TOYGLV.field.ndigits
    k = int(np.random.default_rng(156).integers(2, curve.order - 1))
    pts = multiples(curve, 3)
    tpts = AffinePoint(tplanes([x for x, _ in pts], d), tplanes([y for _, y in pts], d),
                       port_spec(curve))
    kbits = torch.tensor([(k >> i) & 1 for i in range(curve.field.nbits)])
    port = group.scalar_mult_shared(kbits, JacobianPoint.from_affine(tpts))
    assert _triples(port) == [ocoz.scalar_mult(k, (*q, 1), curve) for q in pts]


def _aff_add(p1, p2, curve):
    """Complete affine add on Python ints; None is infinity."""
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    p = curve.p
    (x1, y1), (x2, y2) = p1, p2
    if x1 == x2:
        if (y1 + y2) % p == 0:
            return None
        lam = (3 * x1 * x1 + curve.a) * pow(2 * y1, -1, p) % p
    else:
        lam = (y2 - y1) * pow(x2 - x1, -1, p) % p
    x3 = (lam * lam - x1 - x2) % p
    return (x3, (lam * (x1 - x3) - y1) % p)


def _oracle_msm(ks, pts, curve):
    acc = None
    for k, (x, y) in zip(ks, pts):
        acc = _aff_add(acc, ocoz.naive_scalar_mult(k, x, y, curve), curve)
    return acc


def _msm(ks, pts, curve, **kw):
    return api.multi_scalar_mult_ints(ks, [x for x, _ in pts], [y for _, y in pts],
                                      port_spec(curve), device="cpu", **kw)


@pytest.mark.parametrize("curve", [TOY64E, TOYGLV], ids=lambda c: c.name)
def test_multi_scalar_mult_matches_the_int_oracle(curve):
    """9 lanes (odd tails) through the strict window (TOY64E) or the strict
    GLV chain (TOYGLV), with an equal pair and an opposite pair of partial
    sums at the tree's first level, through ``multi_scalar_mult`` (its
    1-lane Jacobian result); on TOYGLV a batch whose total is infinity
    through ``multi_scalar_mult_ints``."""
    rng = np.random.default_rng(154)
    n = curve.order
    ks = [int(v) % (n - 1) + 1 for v in rng.integers(1, 1 << 62, size=9)]
    pts = [ocoz.scalar_mult_affine(int(v) % (n - 1) + 1, curve.gx, curve.gy, curve)
           for v in rng.integers(1, 1 << 62, size=9)]
    pts[4], ks[4] = pts[0], ks[0]  # lanes 0 and 4: equal partial sums
    pts[5], ks[5] = (pts[1][0], (curve.p - pts[1][1]) % curve.p), ks[1]  # 1 and 5: opposite
    tc = port_spec(curve)
    res = api.multi_scalar_mult(api.scalars_from_ints(ks, tc, "cpu"),
                                api.points_from_ints([x for x, _ in pts], [y for _, y in pts],
                                                     tc, "cpu"))
    assert res.x.planes.shape == (curve.field.ndigits, 1)
    out = affine.to_affine(res)
    assert (ints(out.x)[0], ints(out.y)[0]) == _oracle_msm(ks, pts, curve)
    if curve is not TOYGLV:
        return
    # k G + (n - k) G + k' Q + (n - k') Q = infinity
    g = (curve.gx, curve.gy)
    assert _msm([ks[2], n - ks[2], ks[3], n - ks[3]], [g, g, pts[3], pts[3]], curve) is None


def test_multi_scalar_mult_ladder_route_and_refusal():
    """use_kernel=False runs the co-Z ladder (kernel A on the card) before
    the tree; a curve whose order is a placeholder is refused."""
    c = TOY64E
    rng = np.random.default_rng(155)
    ks = [int(v) % (c.order - 2) + 1 for v in rng.integers(1, 1 << 62, size=5)]
    pts = multiples(c, 5)
    assert _msm(ks, pts, c, use_kernel=False) == _oracle_msm(ks, pts, c)
    g = api.generator_batch(port_spec(TOY64), 2, device="cpu")
    with pytest.raises(AssertionError, match="order_exact"):
        api.multi_scalar_mult(api.scalars_from_ints([1, 2], port_spec(TOY64), "cpu"), g)


def test_kernel_m_wrapper_takes_cuda_tensors_only():
    tc = port_spec(P256)
    z = torch.zeros((16, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        kbs.level_planes(z, z, z, tc)


# -- kernel M's schedule, transcribed from csrc/batch_sum_lane.cuh
# (batch_sum_tree, batch_sum_block_shared) and csrc/batch_sum_kernel.cuh (the
# launcher's grid), with the wrapper's buffer sizes (kernels/batch_sum.py)

def _kernel_m(x3, levels, threads, resident, add, warp=32, shared=False):
    """Kernel M's launch on (3, D, n) planes (x, y, z stacked) at ``threads``
    threads a block of ``warp``-thread warps and ``resident`` co-resident
    blocks, block 0's levels in shared memory (``shared``) or in the
    scratch, each level's adds by ``add((3, D, h) lanes i, (3, D, h) lanes
    i + h)``. Returns the (3, D, lanes_after(n, levels)) output and the log
    [(phase, lanes in, {output lane: (block, thread) that writes it})].
    Checks on the way that each level writes every output lane once, never
    the scratch buffer it reads (the shared buffer in place, its reads and
    writes apart, as __syncthreads keeps them), inside the wrapper's scratch
    and the block's shared buffer, and that block 0's levels write lane t
    from thread t."""
    _, d, n = x3.shape
    if n == 1:  # batch_sum_planes: a 1-lane batch as it is, no launch
        return x3, []
    h0 = n - n // 2
    scratch = torch.full((3 * d * kbs.scratch_lanes(n),), -7, dtype=x3.dtype)
    tail = torch.full((3, d, threads), -7, dtype=x3.dtype)  # batch_sum_block_shared's
    base = (0, 3 * d * h0)  # batch_sum_tree's buf[2]
    ends = (3 * d * h0, scratch.numel())
    out3 = torch.full((3, d, kbs.lanes_after(n, levels)), -7, dtype=x3.dtype)
    blocks = min(-(-h0 // threads), resident)  # the launcher's grid

    def planes(where, lanes):
        if where == "input":
            assert lanes == n
            return x3
        if where == "output":
            assert lanes == out3.shape[-1]
            return out3
        if where == "shared":
            assert lanes <= threads
            return tail[..., :lanes]
        assert base[where] + 3 * d * lanes <= ends[where]  # px, py, pz in buffer `where`
        return scratch[base[where]:base[where] + 3 * d * lanes].view(3, d, lanes)

    def level(src, m):
        h = m // 2
        r = add(src[..., :h], src[..., h:2 * h])
        return torch.cat([r, src[..., m - 1:]], dim=-1) if m % 2 else r

    log, src, m = [], "input", n
    for lvl in range(levels):
        grid = m > 2 * threads  # else block 0 alone, after the grid phase's last sync
        out = m - m // 2
        last = lvl + 1 == levels
        dst = "output" if last else "shared" if shared and not grid else lvl % 2
        assert dst != src or dst == "shared"  # in place: every read, a sync, every write
        writes = {}
        for b in range(blocks if grid else 1):
            for t in range(threads):
                spread = ((t // warp) * blocks + b) * warp + t % warp  # a warp's lanes, round robin
                start, step = (spread, blocks * threads) if grid else (t, threads)
                for i in range(start, out, step):
                    assert i not in writes
                    writes[i] = (b, t)
        assert sorted(writes) == list(range(out))
        assert grid or all(w == (0, i) for i, w in writes.items())
        # a grid level's warps spread over every block before any block takes two
        assert not grid or len({b for b, _ in writes.values()}) == min(blocks, -(-out // warp))
        assert grid or not shared or src in ("input", "shared", (lvl - 1) % 2)
        planes(dst, out)[...] = level(planes(src, m), m)
        log.append(("grid" if grid else "block", m, writes))
        src, m = dst, out
    return out3, log


# (threads a block, co-resident blocks, threads a warp): toy widths whose
# hand-off to one block comes at small n, and THREADS threads, two blocks an
# SM on 132 SMs
M_LAYOUTS = ((4, 3, 2), (8, 2, 4), (2, 5, 1), (6, 2, 3), (kbs.THREADS, 264, 32))


def _expr_add(memo):
    """An add on lane ids that returns the id of the expression (left, right)."""
    def add(a, b):
        ids = [memo.setdefault(k, 1_000_000 + len(memo))
               for k in zip(a[0, 0].tolist(), b[0, 0].tolist())]
        return torch.tensor(ids, dtype=torch.int64).view(1, 1, -1).expand(3, 1, -1).clone()
    return add


def test_kernel_m_schedule_is_the_plain_tree_for_every_n(monkeypatch):
    """For every n from 1 to 300, five layouts and both homes of block 0's
    levels (shared memory, the scratch), the transcribed schedule of kernel
    M builds the same expression as ``group.batch_sum`` (its complete add
    swapped for the same expression builder on lane ids: which lanes are
    added, in which order, which lane is carried), whole trees and the first
    1, 2 and ceil(log2 n) - 1 levels (against the tree's levels on a list);
    the grid phase hands off to one block where a level's output fits it,
    the grid levels hand a warp's lanes out round robin over the blocks, and
    the block's levels write lane t from thread t. The kernel's threads a
    block are the wrapper's THREADS."""
    header = (ROOT / "ecsimd_tpu_torch/csrc/batch_sum_kernel.cuh").read_text()
    assert f"constexpr int kThreads = {kbs.THREADS};" in header
    memo = {}
    add = _expr_add(memo)
    tc = port_spec(TOY64E)

    def plain_add(p1, p2):
        stack = lambda p: torch.stack([p.x.planes, p.y.planes, p.z.planes])  # noqa: E731
        return JacobianPoint(*(GFp(r, tc.field) for r in add(stack(p1), stack(p2))), tc)

    monkeypatch.setattr(group, "jac_add_complete", plain_add)
    for n in range(1, 301):
        threads, resident, warp = M_LAYOUTS[n % len(M_LAYOUTS)]
        shared = bool(n % 2)
        x3 = torch.arange(n, dtype=torch.int64).view(1, 1, n).expand(3, 1, n).clone()
        got, log = _kernel_m(x3, kbs.depth(n), threads, resident, add, warp, shared)
        ref = group.batch_sum(JacobianPoint(*(GFp(x3[c], tc.field) for c in range(3)), tc))
        assert torch.equal(got, torch.stack([ref.x.planes, ref.y.planes, ref.z.planes])), n
        phases = [p for p, _, _ in log]
        assert phases == sorted(phases, key=("grid", "block").index)  # grid levels, then block
        assert all((m > 2 * threads) == (p == "grid") for p, m, _ in log)
        lanes = list(range(n))
        for lvl in range(1, kbs.depth(n)):
            h = len(lanes) // 2
            lanes = [memo[(lanes[i], lanes[i + h])] for i in range(h)] + lanes[2 * h:]
            if lvl in (1, 2, kbs.depth(n) - 1):
                got, _ = _kernel_m(x3, lvl, threads, resident, add, warp, shared)
                assert got[0, 0].tolist() == lanes and kbs.lanes_after(n, lvl) == len(lanes)


def _schedule_with_the_plain_add(shared):
    """The transcribed schedule driven by the plain complete add on TOY64E
    at 4 threads a block and 3 co-resident blocks of 2-thread warps, block
    0's levels in shared memory (``shared``) or in the scratch."""
    tc = port_spec(TOY64E)
    rng = np.random.default_rng(156)

    def add(a, b):
        jac = lambda t: JacobianPoint(*(GFp(t[c], tc.field) for c in range(3)), tc)  # noqa: E731
        r = group.jac_add_complete(jac(a), jac(b))
        return torch.stack([r.x.planes, r.y.planes, r.z.planes])

    for n in (2, 3, 9, 17, 300):
        pt = _port_jacobian(_batch(rng, TOY64E, max(n, 4))[:n], TOY64E)
        x3 = torch.stack([pt.x.planes, pt.y.planes, pt.z.planes])
        got, log = _kernel_m(x3, kbs.depth(n), 4, 3, add, 2, shared)
        ref = group.batch_sum(pt)
        assert torch.equal(got, torch.stack([ref.x.planes, ref.y.planes, ref.z.planes])), n
        assert sum(p == "grid" for p, _, _ in log) == {2: 0, 3: 0, 9: 1, 17: 2, 300: 6}[n]
        if n == 300:
            first, _ = _kernel_m(x3, 1, 4, 3, add, 2, shared)
            h = n // 2
            assert torch.equal(first, add(x3[..., :h], x3[..., h:]))


def test_kernel_m_schedule_with_the_plain_complete_add():
    """The transcribed schedule driven by the plain complete add on TOY64E
    (equal and opposite pairs, lanes at infinity), block 0's levels in the
    scratch (secp256k1, P-384, P-521): word for word ``group.batch_sum`` at
    n = 2, 3 (one block), 9, 17 (grid levels, then the block) and 300 (six
    grid levels), and the first level (levels = 1) the plain complete add of
    the halves."""
    _schedule_with_the_plain_add(shared=False)


def test_kernel_m_shared_tail_schedule_with_the_plain_complete_add():
    """As above with block 0's levels in shared memory, in place (P-256,
    Wei25519)."""
    _schedule_with_the_plain_add(shared=True)
