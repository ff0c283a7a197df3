"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU with nvcc; elsewhere they skip. The file
imports no JAX, nothing of the JAX package and no other test module, so it
also runs on a machine without JAX (tests/conftest.py imports JAX, hence
--noconftest):

    python -m pytest tests/test_torch_cuda.py -q --noconftest -p no:cacheprovider
"""

import ctypes

import numpy as np
import pytest
import torch

from ecsimd_tpu_torch import api, convert, ecdh, ecdsa, glv, x25519
from ecsimd_tpu_torch.bench import roofline
from ecsimd_tpu_torch.curves import group
from ecsimd_tpu_torch.curves.point import AffinePoint, JacobianPoint
from ecsimd_tpu_torch.field import GFp
from ecsimd_tpu_torch.kernels import _build, affine, comb, field_ops, ladder, mladder, window
from ecsimd_tpu_torch.kernels import glv as kglv
from ecsimd_tpu_torch.oracle import comb as ocomb
from ecsimd_tpu_torch.oracle import coz
from ecsimd_tpu_torch.oracle import window as ow
from ecsimd_tpu_torch.specs import P256, P384, P521, SECP256K1, W25519_FIELD, WEI25519

pytestmark = pytest.mark.cuda
D = P256.field.ndigits


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def ints(t):
    return convert.planes_to_ints(t.cpu().numpy())


def rand_ints(rng, bound, n, edges=()):
    vals = list(edges) + [int.from_bytes(rng.bytes(40), "little") % bound for _ in range(n)]
    return vals[:n]


def multiples(curve, n):
    """Affine (i+1)*G for i < n."""
    p = curve.p
    jacs = [(curve.gx, curve.gy, 1), ow._jac_dbl((curve.gx, curve.gy, 1), curve)]
    while len(jacs) < n:
        jacs.append(ow._jac_add(jacs[-1], jacs[0], curve))
    return [(x * pow(z, -2, p) % p, y * pow(z, -3, p) % p) for x, y, z in jacs[:n]]


def _planes(vals, dev):
    return torch.from_numpy(convert.ints_to_planes(vals, D)).to(dev)


def _scalars(n, seed, dev, curve=P256):
    edges = [1, 2, 5, curve.order - 2]
    ks = [k + 1 for k in rand_ints(np.random.default_rng(seed), curve.order - 2, n,
                                   edges=[e - 1 for e in edges])]
    return ks, _planes(ks, dev)


def _comb_tables(curve, dev):
    """The plain comb's tables and -B, the kernels' negbase digits, and kernels
    B's, J's, K's and L's u8 table (``comb.mma_tables``)."""
    tables, negbase, nb = comb.device_tables(curve, curve.gx, curve.gy, dev)
    return tables, negbase, nb, comb.mma_tables(curve, curve.gx, curve.gy, dev)


def test_field_probe_kernel_matches_plain(cuda):
    p = P256.p
    rng = np.random.default_rng(40)
    a = rand_ints(rng, p, 4096, edges=[0, 1, p - 1, p - 2])
    b = rand_ints(rng, p, 4096, edges=[p - 1, p - 2, 0, 1])
    ta, tb = _planes(a, cuda), _planes(b, cuda)
    before = field_ops.KERNEL.launches
    got = field_ops.probe(ta, tb)
    assert field_ops.KERNEL.launches == before + 1
    assert torch.equal(got, field_ops.probe_plain(ta, tb))
    assert ints(got[0, :, :64]) == [x * y % p for x, y in zip(a[:64], b[:64])]


def test_comb_kernel_matches_plain_and_oracle(cuda):
    ks, s = _scalars(1024, 41, cuda)
    tables, negbase, nb, mma = _comb_tables(P256, cuda)
    before = comb.KERNEL.launches
    got = comb.comb_planes(s, mma, nb)
    assert comb.KERNEL.launches == before + 1
    for k, w in zip(got, comb.comb_plain(s, tables, P256, negbase)):
        assert torch.equal(k, w)
    out = api.scalar_mult_base(s[:, :16].contiguous())
    assert list(zip(ints(out.x), ints(out.y))) == [
        coz.scalar_mult_affine(k, P256.gx, P256.gy, P256) for k in ks[:16]]


def test_ladder_kernel_matches_plain_and_oracle(cuda):
    ks, s = _scalars(256, 42, cuda)
    pts = multiples(P256, 256)
    xs, ys = _planes([x for x, _ in pts], cuda), _planes([y for _, y in pts], cuda)
    before = ladder.KERNEL.launches
    got = ladder.ladder_planes(s, xs, ys)
    assert ladder.KERNEL.launches == before + 1
    want = group.scalar_mult(s, JacobianPoint.from_affine(AffinePoint(xs, ys, P256)))
    for k, w in zip(got, (want.x.planes, want.y.planes, want.z.planes)):
        assert torch.equal(k, w)
    out = api.scalar_mult(s[:, :16].contiguous(), AffinePoint(
        xs[:, :16].contiguous(), ys[:, :16].contiguous(), P256))
    assert list(zip(ints(out.x), ints(out.y))) == [
        coz.scalar_mult_affine(k, x, y, P256) for k, (x, y) in zip(ks[:16], pts[:16])]


def test_affine_kernel_matches_plain_and_oracle(cuda):
    ks, s = _scalars(1024, 43, cuda)
    tables, negbase, _, _ = _comb_tables(P256, cuda)
    x, y, z = comb.comb_plain(s, tables, P256, negbase)
    z[:, 0] = 0  # a lane at infinity maps to (0, 0)
    jac = JacobianPoint(*(GFp(t, P256.field) for t in (x, y, z)), P256)
    before = affine.KERNEL.launches
    got = affine.affine_planes(x, y, z)
    assert affine.KERNEL.launches == before + 1
    want = jac.to_affine()
    assert torch.equal(got[0], want.x) and torch.equal(got[1], want.y)
    assert list(zip(ints(got[0][:, :16]), ints(got[1][:, :16]))) == [(0, 0)] + [
        coz.scalar_mult_affine(k, P256.gx, P256.gy, P256) for k in ks[1:16]]


def _neg_or_oracle(ks, pts):
    """k * P by the oracle; (n - 1) P = -P, outside the ladder oracle's domain."""
    n, p = P256.order, P256.p
    return [(x, (p - y) % p) if k == n - 1 else coz.scalar_mult_affine(k, x, y, P256)
            for k, (x, y) in zip(ks, pts)]


def _affine(out, lanes):
    jac = JacobianPoint(*(GFp(t[:, :lanes].contiguous(), P256.field) for t in out), P256)
    aff = jac.to_affine()
    return list(zip(ints(aff.x), ints(aff.y)))


@pytest.mark.parametrize("strict", [False, True], ids=["plain", "strict"])
def test_window_kernel_matches_plain_and_oracle(cuda, strict):
    ks, s = _scalars(256, 44, cuda)
    if strict:
        ks[4] = P256.order - 1
        s = _planes(ks, cuda)
    pts = multiples(P256, 256)
    xs, ys = _planes([x for x, _ in pts], cuda), _planes([y for _, y in pts], cuda)
    kernel = window.KERNEL_STRICT if strict else window.KERNEL
    before = kernel.launches
    got = window.window_planes(s, xs, ys, strict=strict)
    assert kernel.launches == before + 1
    for k, w in zip(got, window.window_plain(s, xs, ys, P256, strict)):
        assert torch.equal(k, w)
    # the plain window degenerates on n - 2 (lane 3): only strict takes it
    lanes = range(16) if strict else [i for i in range(16) if i != 3]
    aff, want = _affine(got, 16), _neg_or_oracle(ks[:16], pts[:16])
    assert [aff[i] for i in lanes] == [want[i] for i in lanes]


def test_strict_comb_kernel_matches_plain_and_oracle(cuda):
    ks, _ = _scalars(1024, 45, cuda)
    ks[4] = P256.order - 1
    s = _planes(ks, cuda)
    tables, negbase, nb, mma = _comb_tables(P256, cuda)
    before = comb.KERNEL_STRICT.launches
    got = comb.comb_planes(s, mma, nb, strict=True)
    assert comb.KERNEL_STRICT.launches == before + 1
    for k, w in zip(got, comb.comb_plain(s, tables, P256, negbase, strict=True)):
        assert torch.equal(k, w)
    assert _affine(got, 16) == _neg_or_oracle(ks[:16], [(P256.gx, P256.gy)] * 16)


def _jacobian_planes(out):
    return out.x.planes, out.y.planes, out.z.planes


@pytest.mark.parametrize("kw", [{"chain": "tree"}, {"chains": 2}, {"chains": 2, "unroll": 2},
                                {"chains": 4}],
                         ids=lambda kw: "-".join(f"{k}{v}" for k, v in kw.items()))
def test_comb_schedule_kernels_match_plain_and_oracle(cuda, kw):
    """Kernels J (tree) and L (chains 2, 4) through comb.scalar_mult_base on
    65,536 lanes against comb_tree_plain / comb_chains_plain (exact), and 16
    lanes against the oracle."""
    ks, s = _scalars(65536, 90, cuda)
    tables, negbase, _, _ = _comb_tables(P256, cuda)
    if "chain" in kw:
        kernel, want = comb.KERNELS_TREE[P256], comb.comb_tree_plain(s, tables, P256, negbase)
    else:
        c, u = kw["chains"], kw.get("unroll", 1)
        kernel = comb.KERNELS_GENERAL[(P256, False)]
        want = comb.comb_chains_plain(s, tables, P256, negbase, c, u)
    before = kernel.launches
    out = comb.scalar_mult_base(s, P256, **kw)
    assert kernel.launches == before + 1
    for k, w in zip(_jacobian_planes(out), want):
        assert torch.equal(k, w)
    assert _affine(_jacobian_planes(out), 16) == [
        coz.scalar_mult_affine(k, P256.gx, P256.gy, P256) for k in ks[:16]]


@pytest.mark.parametrize("kw", [{"chain": "pipe"}, {"unroll": 2}, {"unroll": 4},
                                {"unroll": 2, "strict": True}, {"unroll": 4, "strict": True}],
                         ids=lambda kw: "-".join(f"{k}{v}" for k, v in kw.items()))
def test_comb_one_chain_kernels_match_kernel_b(cuda, kw):
    """Kernel K (pipe) and kernel L with one chain give kernel B's Jacobian
    planes bit for bit on 65,536 lanes (strict: kernel B strict, k = n - 1
    on lane 4)."""
    strict = kw.get("strict", False)
    ks, _ = _scalars(65536, 91, cuda)
    if strict:
        ks[4] = P256.order - 1
    s = _planes(ks, cuda)
    _, _, nb, mma = _comb_tables(P256, cuda)
    want = comb.comb_planes(s, mma, nb, strict=strict)
    kernel = (comb.KERNELS_PIPE[P256] if "chain" in kw
              else comb.KERNELS_GENERAL[(P256, strict)])
    before = kernel.launches
    out = comb.scalar_mult_base(s, P256, **kw)
    assert kernel.launches == before + 1
    for k, w in zip(_jacobian_planes(out), want):
        assert torch.equal(k, w)


def test_comb_schedule_dynamic_smem_queries(cuda):
    """After a launch, J's and L's ``<entry>_smem`` queries give the dynamic
    shared memory the runtime holds for it (L's at the schedule it last ran):
    positive, within the 227 KiB a Hopper block may have, and larger with
    four positions staged a step than with two."""
    _, s = _scalars(256, 93, cuda)

    def smem(kernel):
        torch.cuda.synchronize()
        fn = getattr(_build.library().lib, kernel.symbol + "_smem")
        fn.argtypes, fn.restype = [], ctypes.c_int
        return fn()

    got = {}
    for c, u, strict in comb.SCHEDULES_L:
        comb.scalar_mult_base(s, P256, chains=c, unroll=u, strict=strict)
        got[(c, u, strict)] = smem(comb.KERNELS_GENERAL[(P256, strict)])
    comb.scalar_mult_base(s, P256, chain="tree")
    got["tree"] = smem(comb.KERNELS_TREE[P256])
    assert all(0 < v <= 227 * 1024 for v in got.values()), got
    assert got[(1, 4, False)] > got[(1, 2, False)] > got[(2, 1, False)] == got[(4, 1, False)]


@pytest.mark.parametrize("kw", [{"chains": 8}, {"chains": 2, "unroll": 4}, {"unroll": 8},
                                {"chains": 4, "unroll": 2}, {"chains": 32},
                                {"unroll": 32, "strict": True}],
                         ids=lambda kw: "-".join(f"{k}{v}" for k, v in kw.items()))
def test_comb_schedules_beyond_kernel_l_raise(cuda, kw):
    """Valid schedules with chains * unroll > 4 run on kernel L through
    comb.scalar_mult_base: one launch of it, Jacobian planes exact against
    comb_chains_plain on 4,096 lanes (strict: k = n - 1 on lane 4), 16
    lanes against the oracle; its shared memory is what
    comb.general_smem_bytes says for the schedule's unroll."""
    strict = kw.get("strict", False)
    c, u = kw.get("chains", 1), kw.get("unroll", 1)
    ks, _ = _scalars(4096, 92, cuda)
    if strict:
        ks[4] = P256.order - 1
    s = _planes(ks, cuda)
    tables, negbase, _, _ = _comb_tables(P256, cuda)
    kernel = comb.KERNELS_GENERAL[(P256, strict)]
    before = kernel.launches
    out = comb.scalar_mult_base(s, P256, **kw)
    assert kernel.launches == before + 1
    for k, w in zip(_jacobian_planes(out),
                    comb.comb_chains_plain(s, tables, P256, negbase, c, u, strict)):
        assert torch.equal(k, w)
    lanes = [i for i in range(16) if strict or not _chains_degenerate(P256, ks[i], c)]
    aff = _affine(_jacobian_planes(out), 16)
    want = _neg_or_oracle(ks[:16], [(P256.gx, P256.gy)] * 16)
    assert [aff[i] for i in lanes] == [want[i] for i in lanes] and len(lanes) >= 12
    fn = getattr(_build.library().lib, kernel.symbol + "_smem")
    fn.argtypes, fn.restype = [], ctypes.c_int
    assert fn() == comb.general_smem_bytes(P256, u)


def _chains_degenerate(curve, k, chains):
    """Whether the chains' composition of k on ints meets a degenerate add."""
    tables_np, negbase_ints = comb.base_tables(curve, curve.gx, curve.gy)
    try:
        ocomb.chains(k, ocomb.classical_tables(tables_np, curve.field), negbase_ints, curve,
                     chains)
        return False
    except ZeroDivisionError:
        return True


@pytest.mark.parametrize("curve", [P256, SECP256K1, WEI25519], ids=lambda c: c.name)
def test_kernel_l_at_the_small_schedules_matches_plain(cuda, curve):
    """Kernel L at every schedule of comb.SCHEDULES_L (chains * unroll <= 4)
    through comb_general_planes gives comb_chains_plain's planes word for
    word on 4,096 lanes (k = n - 1 on lane 4), one launch each."""
    ks, _ = _scalars(4096, 94, cuda, curve)
    ks[4] = curve.order - 1
    s = _planes(ks, cuda)
    tables, negbase, nb, mma = _comb_tables(curve, cuda)
    for c, u, st in comb.SCHEDULES_L:
        kernel = comb.KERNELS_GENERAL[(curve, st)]
        before = kernel.launches
        got = comb.comb_general_planes(s, mma, nb, curve, c, u, st)
        assert kernel.launches == before + 1
        for k, w in zip(got, comb.comb_chains_plain(s, tables, curve, negbase, c, u, st)):
            assert torch.equal(k, w), (c, u, st)


def test_ecdh_on_the_card(cuda):
    """Keygen through kernel B, shared secrets through strict kernel E, with
    a zero scalar, scalar = n, an off-curve peer and x = p in the batch."""
    n, p = P256.order, P256.p
    d1, _ = _scalars(64, 46, cuda)
    d2, _ = _scalars(64, 47, cuda)
    q1x, q1y, ok1 = ecdh.derive_public_planes(_planes(d1, cuda))
    q2x, q2y, ok2 = ecdh.derive_public_planes(_planes(d2, cuda))
    assert bool(ok1.all()) and bool(ok2.all())
    bad = d1[:]
    bad[60], bad[61] = 0, n
    qx, qy = ints(q2x), ints(q2y)
    qy[62] = (qy[62] + 1) % p
    qx[63] = p
    s12, ok12 = ecdh.shared_secret_planes(_planes(bad, cuda), _planes(qx, cuda), _planes(qy, cuda))
    s21, ok21 = ecdh.shared_secret_planes(_planes(d2, cuda), q1x, q1y)
    assert ok12.tolist() == [1] * 60 + [0] * 4 and bool(ok21.all())
    assert ints(s12)[:60] == ints(s21)[:60]
    assert ints(s21)[:8] == [
        coz.scalar_mult_affine(a * b % n, P256.gx, P256.gy, P256)[0] for a, b in zip(d1[:8], d2)]


# --- secp256k1: the CIOS field layer, kernel F and the secp256k1 B, C, D ---------


def _k1_affine(out, lanes):
    jac = JacobianPoint(*(GFp(t[:, :lanes].contiguous(), SECP256K1.field) for t in out), SECP256K1)
    aff = jac.to_affine()
    return list(zip(ints(aff.x), ints(aff.y)))


def _k1_oracle(ks, pts):
    n, p = SECP256K1.order, SECP256K1.p
    out = []
    for k, (x, y) in zip(ks, pts):
        k %= n
        out.append((x, (p - y) % p) if k == n - 1 else (0, 0) if k == 0
                   else coz.scalar_mult_affine(k, x, y, SECP256K1))
    return out


def test_field_probe_kernel_secp256k1(cuda):
    fs = SECP256K1.field
    p = fs.p
    rng = np.random.default_rng(50)
    a = rand_ints(rng, p, 4096, edges=[0, 1, p - 1, p - 2])
    b = rand_ints(rng, p, 4096, edges=[p - 1, p - 2, 0, 1])
    ta, tb = _planes(a, cuda), _planes(b, cuda)
    before = field_ops.KERNEL_SECP256K1.launches
    got = field_ops.probe(ta, tb, fs)
    assert field_ops.KERNEL_SECP256K1.launches == before + 1
    assert torch.equal(got, field_ops.probe_plain(ta, tb, fs))
    # Montgomery products: a b R^-1
    assert ints(got[0, :, :64]) == [x * y * fs.R_inv % p for x, y in zip(a[:64], b[:64])]


@pytest.mark.parametrize("strict", [False, True], ids=["plain", "strict"])
def test_comb_kernel_secp256k1(cuda, strict):
    ks, _ = _scalars(1024, 51, cuda, SECP256K1)
    if strict:
        ks[4] = SECP256K1.order - 1
    s = _planes(ks, cuda)
    tables, negbase, nb, mma = _comb_tables(SECP256K1, cuda)
    kernel = comb.KERNELS[(SECP256K1, strict)]
    before = kernel.launches
    got = comb.comb_planes(s, mma, nb, SECP256K1, strict=strict)
    assert kernel.launches == before + 1
    for k, w in zip(got, comb.comb_plain(s, tables, SECP256K1, negbase, strict=strict)):
        assert torch.equal(k, w)
    g = [(SECP256K1.gx, SECP256K1.gy)] * 16
    lanes = range(16) if strict else [i for i in range(16) if i != 3]  # n - 2
    aff, want = _k1_affine(got, 16), _k1_oracle(ks[:16], g)
    assert [aff[i] for i in lanes] == [want[i] for i in lanes]


def test_affine_kernel_secp256k1(cuda):
    ks, s = _scalars(1024, 52, cuda, SECP256K1)
    tables, negbase, _, _ = _comb_tables(SECP256K1, cuda)
    x, y, z = comb.comb_plain(s, tables, SECP256K1, negbase)
    z[:, 0] = 0
    jac = JacobianPoint(*(GFp(t, SECP256K1.field) for t in (x, y, z)), SECP256K1)
    before = affine.KERNEL_SECP256K1.launches
    got = affine.affine_planes(x, y, z, SECP256K1)
    assert affine.KERNEL_SECP256K1.launches == before + 1
    want = jac.to_affine()
    assert torch.equal(got[0], want.x) and torch.equal(got[1], want.y)
    assert list(zip(ints(got[0][:, :16]), ints(got[1][:, :16]))) == [(0, 0)] + _k1_oracle(
        ks[1:16], [(SECP256K1.gx, SECP256K1.gy)] * 15)


@pytest.mark.parametrize("strict", [False, True], ids=["plain", "strict"])
def test_glv_kernel_matches_plain_and_oracle(cuda, strict):
    """Kernel F against glv_plain on 256 lanes with the lambda-class scalars
    (k1 = 0, collisions mid-chain); strict also against the oracle."""
    n = SECP256K1.order
    lam = glv.glv_params(SECP256K1).lam
    ks, _ = _scalars(256, 53, cuda, SECP256K1)
    ks[:8] = [1, 2, lam, lam - 1, lam + 1, n - 1, n - 2, 3]
    s = _planes(ks, cuda)
    pts = multiples(SECP256K1, 256)
    pt = AffinePoint(_planes([x for x, _ in pts], cuda), _planes([y for _, y in pts], cuda),
                     SECP256K1)
    packed = kglv.pack_scalars(s, SECP256K1)
    xm = GFp.from_classical(pt.x, SECP256K1.field).planes.contiguous()
    ym = GFp.from_classical(pt.y, SECP256K1.field).planes.contiguous()
    kernel = kglv.KERNEL_STRICT if strict else kglv.KERNEL
    before = kernel.launches
    got = kglv.glv_planes(packed, xm, ym, SECP256K1, strict=strict)
    assert kernel.launches == before + 1
    for k, w in zip(got, kglv.glv_plain(packed, xm, ym, SECP256K1, strict)):
        assert torch.equal(k, w)
    if strict:
        want = _k1_oracle([k * (i + 1) for i, k in enumerate(ks[:16])], [pts[0]] * 16)
        assert _k1_affine(got, 16) == want


@pytest.mark.parametrize("curve", [P256, SECP256K1], ids=lambda c: c.name)
def test_ecdsa_on_the_card(cuda, curve):
    """sign -> verify -> recover on 64 lanes: every honest signature
    verifies, a tampered r does not, and one of the two recovery ids gives Q."""
    n = curve.order
    d, _ = _scalars(64, 54, cuda, curve)
    k, _ = _scalars(64, 55, cuda, curve)
    z = rand_ints(np.random.default_rng(56), 1 << 256, 64)
    q = api.scalar_mult_base(_planes(d, cuda), curve)
    r, s, ok = ecdsa.sign_planes(_planes(z, cuda), _planes(d, cuda), _planes(k, cuda), curve)
    assert bool(ok.all())
    rk = coz.scalar_mult_affine(k[7], curve.gx, curve.gy, curve)[0] % n
    assert ints(r)[7] == rk and ints(s)[7] == pow(k[7], -1, n) * (z[7] % n + rk * d[7]) % n
    v = ecdsa.verify_planes(_planes(z, cuda), r, s, q.x, q.y, curve)
    assert bool(v.all())
    r_bad = ints(r)
    r_bad[5] = (r_bad[5] + 1) % n
    v = ecdsa.verify_planes(_planes(z, cuda), _planes(r_bad, cuda), s, q.x, q.y, curve)
    assert v.tolist() == [1] * 5 + [0] + [1] * 58
    found = torch.zeros(64, dtype=torch.bool, device=cuda)
    for vid in (0, 1):
        rx, ry, okr = ecdsa.recover_planes(_planes(z, cuda), r, s,
                                           torch.full((64,), vid, dtype=torch.int32, device=cuda),
                                           curve)
        found |= okr.bool() & (rx == q.x).all(0) & (ry == q.y).all(0)
    assert bool(found.all())


# --- X25519 (2^255 - 19) and the calibration -------------------------------------

P25519 = W25519_FIELD.p


def _x25519_int(k, u):
    """RFC 7748 §5 ladder on Python ints (clamped k, any u): the output u."""
    p = P25519
    x2, z2, x3, z3, swap = 1, 0, u % p, 1, 0
    for t in range(254, -1, -1):
        kt = (k >> t) & 1
        if swap ^ kt:
            x2, x3, z2, z3 = x3, x2, z3, z2
        swap = kt
        a, b, c, d = (x2 + z2) % p, (x2 - z2) % p, (x3 + z3) % p, (x3 - z3) % p
        aa, bb, da, cb = a * a % p, b * b % p, d * a % p, c * b % p
        e = (aa - bb) % p
        x3, z3 = (da + cb) ** 2 % p, u * (da - cb) ** 2 % p
        x2, z2 = aa * bb % p, e * (aa + x25519.A24 * e) % p
    if swap:
        x2, z2 = x3, z3
    return x2 * pow(z2, p - 2, p) % p


def _clamped(rng, n):
    return [x25519.clamp(rng.bytes(32)) for _ in range(n)]


def test_field_probe_kernel_w25519(cuda):
    fs = W25519_FIELD
    p = fs.p
    rng = np.random.default_rng(80)
    a = rand_ints(rng, p, 4096, edges=[0, 1, p - 1, p - 2, p - 19, 2**254])
    b = rand_ints(rng, p, 4096, edges=[p - 1, p - 2, 0, 1, p - 1, 2**254])
    ta, tb = _planes(a, cuda), _planes(b, cuda)
    before = field_ops.KERNEL_W25519.launches
    got = field_ops.probe(ta, tb, fs)
    assert field_ops.KERNEL_W25519.launches == before + 1
    assert torch.equal(got, field_ops.probe_plain(ta, tb, fs))
    assert ints(got[0, :, :64]) == [x * y % p for x, y in zip(a[:64], b[:64])]
    assert ints(got[1, :, :64]) == [x * x % p for x in a[:64]]


def test_mladder_and_xdivz_kernels_match_plain_and_ints(cuda):
    rng = np.random.default_rng(81)
    ks = _clamped(rng, 1024)
    us = rand_ints(rng, P25519, 1024, edges=[0, 1, P25519 - 1, 9])
    k, u = _planes(ks, cuda), _planes(us, cuda)
    before = (mladder.KERNEL.launches, mladder.KERNEL_XDIVZ.launches)
    x2, z2 = mladder.mladder_planes(k, u, W25519_FIELD, x25519.A24, 255)
    got = mladder.xdivz(x2, z2)
    assert (mladder.KERNEL.launches, mladder.KERNEL_XDIVZ.launches) == (before[0] + 1,
                                                                        before[1] + 1)
    px, pz = mladder.mladder_plain(k, u, W25519_FIELD, x25519.A24, 255)
    assert torch.equal(x2, px) and torch.equal(z2, pz)
    assert torch.equal(got, mladder.xdivz_plain(x2, z2, W25519_FIELD))
    assert ints(got[:, :32]) == [_x25519_int(kk, uu) for kk, uu in zip(ks[:32], us[:32])]
    assert ints(got[:, :2]) == [0, 0]  # u = 0 and u = 1 are low order


def test_x25519_keygen_and_exchange_on_the_card(cuda):
    """Comb B and affine D on Wei25519 against their plain versions, then
    derive_public and the exchange both ways against the int ladder."""
    rng = np.random.default_rng(82)
    ks = _clamped(rng, 512)
    s = _planes(ks, cuda)
    tables, negbase, nb, mma = _comb_tables(WEI25519, cuda)
    before = (comb.KERNEL_W25519.launches, affine.KERNEL_W25519.launches)
    jac = comb.comb_planes(s, mma, nb, WEI25519)
    for kk, w in zip(jac, comb.comb_plain(s, tables, WEI25519, negbase)):
        assert torch.equal(kk, w)
    ax, ay = affine.affine_planes(*jac, WEI25519)
    plain = JacobianPoint(*(GFp(t, W25519_FIELD) for t in jac), WEI25519).to_affine()
    assert torch.equal(ax, plain.x) and torch.equal(ay, plain.y)
    q = x25519.derive_public_planes(s)
    assert (comb.KERNEL_W25519.launches, affine.KERNEL_W25519.launches) == (before[0] + 2,
                                                                            before[1] + 2)
    assert ints(q[:, :16]) == [_x25519_int(kk, 9) for kk in ks[:16]]
    # lane i: k_i with Q_{i-1}, and k_{i-1} with Q_i
    s12 = x25519.x25519_planes(s, torch.roll(q, 1, dims=1).contiguous())
    s21 = x25519.x25519_planes(torch.roll(s, 1, dims=1).contiguous(), q)
    assert torch.equal(s12, s21)
    assert ints(s12[:, 1:9]) == [_x25519_int(kk, _x25519_int(kp, 9))
                                 for kk, kp in zip(ks[1:9], ks[:8])]


def test_calib_kernel_matches_plain(cuda):
    rng = np.random.default_rng(83)
    a, b = (torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, size=4096, dtype=np.int64)
                             .astype(np.int32)).to(cuda) for _ in range(2))
    before = roofline.KERNEL.launches
    got = roofline.calib(a, b, 10)
    assert roofline.KERNEL.launches == before + 1
    assert torch.equal(got.cpu(), roofline.calib_plain(a.cpu(), b.cpu(), 10))
    rate = roofline.measure_int32_ceiling(reps=1 << 10, iters=2)
    assert rate["int32_ops_per_s"] > 0
    assert rate["imad_per_s"] * 5 == pytest.approx(rate["int32_ops_per_s"])


# --- secp256k1 and Wei25519: kernels A, E, B strict (Wei25519), J, K, L ------------

OTHER = [SECP256K1, WEI25519]


def _curve_affine(out, lanes, curve):
    jac = JacobianPoint(*(GFp(t[:, :lanes].contiguous(), curve.field) for t in out), curve)
    aff = jac.to_affine()
    return list(zip(ints(aff.x), ints(aff.y)))


def _curve_oracle(ks, pts, curve):
    """k * P by the oracle for any k: (n - 1) P = -P, 0 P = infinity (0, 0)."""
    n, p = curve.order, curve.p
    out = []
    for k, (x, y) in zip(ks, pts):
        k %= n
        out.append((x, (p - y) % p) if k == n - 1 else (0, 0) if k == 0
                   else coz.scalar_mult_affine(k, x, y, curve))
    return out


def _varbase(curve, n, seed, dev, last=None):
    """Scalars (edges 1, 2, 5, n - 2; lane 4 set to ``last``) and the
    points (i+1)G, lane 0 the generator itself (z = 1 through its table)."""
    ks, _ = _scalars(n, seed, dev, curve)
    if last is not None:
        ks[4] = last
    pts = multiples(curve, n)
    pt = AffinePoint(_planes([x for x, _ in pts], dev), _planes([y for _, y in pts], dev), curve)
    return ks, _planes(ks, dev), pts, pt


@pytest.mark.parametrize("curve", OTHER, ids=lambda c: c.name)
def test_ladder_kernel_other_curves(cuda, curve):
    """Kernel A through ladder.scalar_mult (coordinates converted to the
    field's internal form) against the plain ladder on 1,024 lanes, and
    api.scalar_mult against the oracle on 16."""
    ks, s, pts, pt = _varbase(curve, 1024, 94, cuda)
    kernel = ladder.KERNELS[curve]
    before = kernel.launches
    got = ladder.scalar_mult(s, pt)
    assert kernel.launches == before + 1
    want = group.scalar_mult(s, JacobianPoint.from_affine(pt))
    for k, w in zip((got.x, got.y, got.z), (want.x, want.y, want.z)):
        assert torch.equal(k.planes, w.planes)
    out = api.scalar_mult(s[:, :16].contiguous(), AffinePoint(
        pt.x[:, :16].contiguous(), pt.y[:, :16].contiguous(), curve))
    assert list(zip(ints(out.x), ints(out.y))) == _curve_oracle(ks[:16], pts[:16], curve)


@pytest.mark.parametrize("strict", [False, True], ids=["plain", "strict"])
@pytest.mark.parametrize("curve", OTHER, ids=lambda c: c.name)
def test_window_kernel_other_curves(cuda, curve, strict):
    """Kernel E (strict: k = n - 1 on lane 4) through window.scalar_mult
    against window_plain on 1,024 lanes, and 16 lanes against the oracle
    (the plain window's degenerate lanes excluded, as the window oracle
    finds them)."""
    ks, s, pts, pt = _varbase(curve, 1024, 95, cuda, curve.order - 1 if strict else None)
    kernel = window.KERNELS[(curve, strict)]
    before = kernel.launches
    got = window.scalar_mult(s, pt, strict=strict)
    assert kernel.launches == before + 1
    xm = GFp.from_classical(pt.x, curve.field).planes.contiguous()
    ym = GFp.from_classical(pt.y, curve.field).planes.contiguous()
    for k, w in zip((got.x, got.y, got.z), window.window_plain(s, xm, ym, curve, strict)):
        assert torch.equal(k.planes, w)

    def degenerate(k, pt):
        try:
            ow.scalar_mult(k, (*pt, 1), curve)
            return False
        except ZeroDivisionError:
            return True

    lanes = [i for i in range(16) if strict or not degenerate(ks[i], pts[i])]
    aff = _curve_affine((got.x.planes, got.y.planes, got.z.planes), 16, curve)
    want = _curve_oracle(ks[:16], pts[:16], curve)
    assert [aff[i] for i in lanes] == [want[i] for i in lanes]


def test_strict_comb_kernel_w25519(cuda):
    ks, _ = _scalars(1024, 96, cuda, WEI25519)
    ks[4] = WEI25519.order - 1
    s = _planes(ks, cuda)
    tables, negbase, nb, mma = _comb_tables(WEI25519, cuda)
    kernel = comb.KERNELS[(WEI25519, True)]
    before = kernel.launches
    got = comb.comb_planes(s, mma, nb, WEI25519, strict=True)
    assert kernel.launches == before + 1
    for k, w in zip(got, comb.comb_plain(s, tables, WEI25519, negbase, strict=True)):
        assert torch.equal(k, w)
    g = [(WEI25519.gx, WEI25519.gy)] * 16
    assert _curve_affine(got, 16, WEI25519) == _curve_oracle(ks[:16], g, WEI25519)


SCHEDULES = [{"chain": "tree"}, {"chain": "pipe"}] + [
    {"chains": c, "unroll": u, "strict": st} for c, u, st in comb.SCHEDULES_L]


@pytest.mark.parametrize("kw", SCHEDULES, ids=lambda kw: "-".join(f"{k}{v}" for k, v in kw.items()))
@pytest.mark.parametrize("curve", OTHER, ids=lambda c: c.name)
def test_comb_schedule_kernels_other_curves(cuda, curve, kw):
    """Kernels J, K and L through comb.scalar_mult_base on 1,024 lanes
    against their plain versions (K and one-chain L: comb_plain, strict with
    k = n - 1 on lane 4), and 16 lanes against the oracle (lanes where the
    schedule's composition on ints meets a degenerate add excluded). J and
    K take the u8 table: comb.schedule_planes gives the same planes."""
    strict = kw.get("strict", False)
    ks, _ = _scalars(1024, 97, cuda, curve)
    if strict:
        ks[4] = curve.order - 1
    s = _planes(ks, cuda)
    tables, negbase, nb, mma = _comb_tables(curve, cuda)
    chains, unroll = kw.get("chains", 1), kw.get("unroll", 1)
    if kw.get("chain") == "tree":
        kernel, want = comb.KERNELS_TREE[curve], comb.comb_tree_plain(s, tables, curve, negbase)
    elif kw.get("chain") == "pipe":
        kernel, want = comb.KERNELS_PIPE[curve], comb.comb_plain(s, tables, curve, negbase)
    else:
        kernel = comb.KERNELS_GENERAL[(curve, strict)]
        want = comb.comb_chains_plain(s, tables, curve, negbase, chains, unroll, strict)
    before = kernel.launches
    out = comb.scalar_mult_base(s, curve, **kw)
    assert kernel.launches == before + 1
    for k, w in zip(_jacobian_planes(out), want):
        assert torch.equal(k, w)
    if "chain" in kw:
        for k, w in zip(comb.schedule_planes(s, mma, nb, curve, **kw), want):
            assert torch.equal(k, w)
    tables_np, negbase_ints = comb.base_tables(curve, curve.gx, curve.gy)
    classical = ocomb.classical_tables(tables_np, curve.field)

    def degenerate(k):
        try:
            if kw.get("chain") == "tree":
                ocomb.tree(k, classical, negbase_ints, curve)
            else:
                ocomb.chains(k, classical, negbase_ints, curve, chains)
            return False
        except ZeroDivisionError:
            return True

    lanes = [i for i in range(16) if strict or not degenerate(ks[i])]
    aff = _curve_affine(_jacobian_planes(out), 16, curve)
    want = _curve_oracle(ks[:16], [(curve.gx, curve.gy)] * 16, curve)
    assert [aff[i] for i in lanes] == [want[i] for i in lanes]
    assert len(lanes) >= 12


# --- P-384 and P-521: kernels A, B (both modes), C, D and E (both modes) ------------

WIDE = [P384, P521]


def _wide_planes(vals, curve, dev):
    return torch.from_numpy(convert.ints_to_planes(vals, curve.field.ndigits)).to(dev)


def _wide_scalars(curve, n, seed, dev, last=None):
    """Scalars uniform mod n (edges 1, 2, 5, n - 2 first; lane 4 ``last``)."""
    rng = np.random.default_rng(seed)
    nbytes = (curve.order.bit_length() + 7) // 8 + 8
    ks = [1, 2, 5, curve.order - 2] + [
        int.from_bytes(rng.bytes(nbytes), "little") % (curve.order - 1) + 1 for _ in range(n - 4)]
    if last is not None:
        ks[4] = last
    return ks, _wide_planes(ks, curve, dev)


def _wide_points(curve, n, dev):
    """(i+1) G on the first 16 lanes (lane 0: G, z = 1 through the
    tables), G on the rest."""
    pts = multiples(curve, 16) + [(curve.gx, curve.gy)] * (n - 16)
    return pts, AffinePoint(_wide_planes([x for x, _ in pts], curve, dev),
                            _wide_planes([y for _, y in pts], curve, dev), curve)


@pytest.mark.parametrize("curve", WIDE, ids=lambda c: c.name)
def test_field_probe_kernel_wide(cuda, curve):
    """Kernel C on the P-384 (Solinas) and P-521 (Mersenne fold) layers:
    4,096 lanes, edge pairs first (p - 1, words of all ones, P-521's 9-bit
    top word), against the plain GFp and 64 lanes against ints; and its
    constant-operand form (1, 2, p - 1 and 0 as compile-time constants
    through every new chain) against the plain version."""
    fs, p = curve.field, curve.p
    words = (fs.ndigits + 1) // 2
    edges = [0, 1, 2, p - 1, p - 2, p >> 1, ((1 << (32 * words)) - 1) % p,
             (0x1FF << 512) % p, (1 << 512) % p, ((1 << 512) - 1) % p]
    pairs = [(x, y) for x in edges for y in edges]
    rng = np.random.default_rng(98)
    a = [x for x, _ in pairs] + rand_ints(rng, p, 4096 - len(pairs))
    b = [y for _, y in pairs] + rand_ints(rng, p, 4096 - len(pairs))
    ta, tb = _wide_planes(a, curve, cuda), _wide_planes(b, curve, cuda)
    kernel = field_ops.KERNELS[fs]
    before = kernel.launches
    got = field_ops.probe(ta, tb, fs)
    assert kernel.launches == before + 1
    assert torch.equal(got, field_ops.probe_plain(ta, tb, fs))
    got_ints = [ints(got[k, :, :64]) for k in range(5)]
    assert got_ints == [[x * y % p for x, y in zip(a[:64], b)], [x * x % p for x in a[:64]],
                        [(x + y) % p for x, y in zip(a[:64], b)],
                        [(x - y) % p for x, y in zip(a[:64], b)], [(-x) % p for x in a[:64]]]
    assert torch.equal(field_ops.constants(fs, cuda).cpu(), field_ops.constants_plain(fs))


@pytest.mark.parametrize("curve", WIDE, ids=lambda c: c.name)
def test_ladder_kernel_wide(cuda, curve):
    """Kernel A through api.scalar_mult against the plain ladder on 256
    lanes and the oracle on 16 (points (i+1)G)."""
    ks, s = _wide_scalars(curve, 256, 99, cuda)
    pts, pt = _wide_points(curve, 256, cuda)
    kernel = ladder.KERNELS[curve]
    before = kernel.launches
    got = ladder.scalar_mult(s, pt)
    assert kernel.launches == before + 1
    want = group.scalar_mult(s, JacobianPoint.from_affine(pt))
    for k, w in zip((got.x, got.y, got.z), (want.x, want.y, want.z)):
        assert torch.equal(k.planes, w.planes)
    out = affine.to_affine(got)
    assert list(zip(ints(out.x[:, :16]), ints(out.y[:, :16]))) == _curve_oracle(
        ks[:16], pts[:16], curve)


@pytest.mark.parametrize("strict", [False, True], ids=["plain", "strict"])
@pytest.mark.parametrize("curve", WIDE, ids=lambda c: c.name)
def test_window_kernel_wide(cuda, curve, strict):
    """Kernel E (strict: k = n - 1 on lane 4) against window_plain on 256
    lanes and the oracle on 16 (the plain window's degenerate lanes
    excluded)."""
    ks, s = _wide_scalars(curve, 256, 100, cuda, curve.order - 1 if strict else None)
    pts, pt = _wide_points(curve, 256, cuda)
    kernel = window.KERNELS[(curve, strict)]
    before = kernel.launches
    got = window.scalar_mult(s, pt, strict=strict)
    assert kernel.launches == before + 1
    for k, w in zip((got.x, got.y, got.z), window.window_plain(s, pt.x, pt.y, curve, strict)):
        assert torch.equal(k.planes, w)

    def degenerate(k, pt):
        try:
            ow.scalar_mult(k, (*pt, 1), curve)
            return False
        except ZeroDivisionError:
            return True

    lanes = [i for i in range(16) if strict or not degenerate(ks[i], pts[i])]
    aff = _curve_affine((got.x.planes, got.y.planes, got.z.planes), 16, curve)
    want = _curve_oracle(ks[:16], pts[:16], curve)
    assert [aff[i] for i in lanes] == [want[i] for i in lanes] and len(lanes) >= 14


LANES_PAST_THE_SLOTS = 70_000  # more than 132 SMs x 256 threads, not a multiple of 64


@pytest.mark.parametrize("strict", [False, True], ids=["plain", "strict"])
@pytest.mark.parametrize("curve", WIDE, ids=lambda c: c.name)
def test_window_kernel_wide_lanes_are_independent(cuda, curve, strict):
    """Kernel E's persistent walk and the reuse of a slot's scratch column:
    on 70,000 random lanes (scalars mod n, points k G from the comb), more
    than the card's resident threads, its first and last 256 lanes equal E
    run on those 256 lanes alone."""
    n = LANES_PAST_THE_SLOTS
    _, s = _wide_scalars(curve, n, 107, cuda)
    _, base = _wide_scalars(curve, n, 108, cuda)
    pt = api.scalar_mult_base(base, curve)
    slots = window.resident_slots(window.KERNELS[(curve, strict)], curve, cuda)
    assert n > slots and n % 64
    full = window.scalar_mult(s, pt, strict=strict)
    for part in (slice(0, 256), slice(n - 256, n)):
        sub = AffinePoint(pt.x[:, part].contiguous(), pt.y[:, part].contiguous(), curve)
        alone = window.scalar_mult(s[:, part].contiguous(), sub, strict=strict)
        for k, w in zip((full.x, full.y, full.z), (alone.x, alone.y, alone.z)):
            assert torch.equal(k.planes[:, part], w.planes)


@pytest.mark.parametrize("strict", [False, True], ids=["plain", "strict"])
@pytest.mark.parametrize("curve", WIDE, ids=lambda c: c.name)
def test_window_kernel_wide_queries_match_the_split(cuda, curve, strict):
    """After a launch, each wide E's ``_smem`` query gives the Python split's
    shared bytes a block and its ``_occupancy`` query at least the target
    four blocks of 64 threads an SM (eight warps); the scratch the wrapper
    allocates has one column for each resident thread."""
    kernel = window.KERNELS[(curve, strict)]
    sp = window.table_split(curve)
    _, s = _wide_scalars(curve, 64, 109, cuda)
    _, pt = _wide_points(curve, 64, cuda)
    window.scalar_mult(s, pt, strict=strict)
    lib = _build.library().lib
    for q, want in (("_smem", sp.smem_bytes), ("_occupancy", None)):
        fn = getattr(lib, kernel.symbol + q)
        fn.argtypes, fn.restype = [], ctypes.c_int
        got = fn()
        if want is None:
            assert got >= sp.blocks and got == window.occupancy(kernel.symbol)
        else:
            assert got == want
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    scratch = window.scratch_for(kernel, curve, cuda)
    assert tuple(scratch.shape) == (sp.scratch_vecs, sms * window.occupancy(kernel.symbol) * 64, 4)


@pytest.mark.parametrize("strict", [False, True], ids=["plain", "strict"])
@pytest.mark.parametrize("curve", WIDE, ids=lambda c: c.name)
def test_comb_and_affine_kernels_wide(cuda, curve, strict):
    """Kernel B (strict: k = n - 1 on lane 4) against comb_plain on 1,024
    lanes, through kernel D (one lane at infinity) against to_affine, and
    16 lanes against the oracle."""
    ks, s = _wide_scalars(curve, 1024, 101, cuda, curve.order - 1 if strict else None)
    tables, negbase, nb = comb.device_tables(curve, curve.gx, curve.gy, cuda)
    mma = comb.mma_tables(curve, curve.gx, curve.gy, cuda)
    kernel = comb.KERNELS[(curve, strict)]
    before = kernel.launches
    got = comb.comb_planes(s, mma, nb, curve, strict)
    assert kernel.launches == before + 1
    for k, w in zip(got, comb.comb_plain(s, tables, curve, negbase, strict)):
        assert torch.equal(k, w)
    jx, jy, jz = (t.clone() for t in got)
    jz[:, -1] = 0
    aff = affine.affine_planes(jx, jy, jz, curve)
    plain = JacobianPoint(*(GFp(t, curve.field) for t in (jx, jy, jz)), curve).to_affine()
    assert torch.equal(aff[0], plain.x) and torch.equal(aff[1], plain.y)
    assert not bool(aff[0][:, -1].any() or aff[1][:, -1].any())
    lanes = [i for i in range(16) if strict or i != 4]  # n - 1: not in the plain comb's domain
    got16 = list(zip(ints(aff[0][:, :16]), ints(aff[1][:, :16])))
    want = _curve_oracle(ks[:16], [(curve.gx, curve.gy)] * 16, curve)
    assert [got16[i] for i in lanes] == [want[i] for i in lanes]


WIDE_SCHEDULES = [{"chain": "tree"}, {"chain": "pipe"}, {"chains": 2}, {"chains": 3},
                  {"unroll": 2}, {"unroll": 3, "strict": True}]


@pytest.mark.parametrize("kw", WIDE_SCHEDULES,
                         ids=lambda kw: "-".join(f"{k}{v}" for k, v in kw.items()))
@pytest.mark.parametrize("curve", WIDE, ids=lambda c: c.name)
def test_comb_schedules_refuse_the_wide_curves_on_the_card(cuda, curve, kw):
    """Kernels J (tree), K (pipe) and the generic L through
    comb.scalar_mult_base on P-384 and P-521: one launch of the curve's
    kernel, Jacobian planes exact against comb_tree_plain / comb_plain /
    comb_chains_plain on 1,024 lanes (strict: k = n - 1 on lane 4), 16
    lanes against the oracle (lanes whose composition on ints degenerates
    excluded). J and K take the u8 table: comb.schedule_planes gives the
    same planes."""
    strict = kw.get("strict", False)
    c, u = kw.get("chains", 1), kw.get("unroll", 1)
    ks, s = _wide_scalars(curve, 1024, 102, cuda, curve.order - 1 if strict else None)
    tables, negbase, nb, mma = _comb_tables(curve, cuda)
    if kw.get("chain") == "tree":
        kernel, want = comb.KERNELS_TREE[curve], comb.comb_tree_plain(s, tables, curve, negbase)
    elif kw.get("chain") == "pipe":
        kernel, want = comb.KERNELS_PIPE[curve], comb.comb_plain(s, tables, curve, negbase)
    else:
        kernel = comb.KERNELS_GENERAL[(curve, strict)]
        want = comb.comb_chains_plain(s, tables, curve, negbase, c, u, strict)
    before = kernel.launches
    out = comb.scalar_mult_base(s, curve, **kw)
    assert kernel.launches == before + 1
    for k, w in zip(_jacobian_planes(out), want):
        assert torch.equal(k, w)
    if "chain" in kw:
        for k, w in zip(comb.schedule_planes(s, mma, nb, curve, **kw), want):
            assert torch.equal(k, w)
    tables_np, negbase_ints = comb.base_tables(curve, curve.gx, curve.gy)
    classical = ocomb.classical_tables(tables_np, curve.field)

    def degenerate(k):
        try:
            if kw.get("chain") == "tree":
                ocomb.tree(k, classical, negbase_ints, curve)
            else:
                ocomb.chains(k, classical, negbase_ints, curve, c)
            return False
        except ZeroDivisionError:
            return True

    lanes = [i for i in range(16) if strict or not degenerate(ks[i])]
    aff = _curve_affine(_jacobian_planes(out), 16, curve)
    want = _curve_oracle(ks[:16], [(curve.gx, curve.gy)] * 16, curve)
    assert [aff[i] for i in lanes] == [want[i] for i in lanes] and len(lanes) >= 12


def test_ecdh_and_ecdsa_p384_on_the_card(cuda):
    """P-384 through the protocols on the card: ECDH keys and secrets both
    ways (every lane), ECDSA with 384-bit hashes signed, verified and
    recovered, 8 lanes against the oracle's composition."""
    curve = P384
    n = curve.order
    d1, s1 = _wide_scalars(curve, 64, 103, cuda)
    d2, s2 = _wide_scalars(curve, 64, 104, cuda)
    q1x, q1y, ok1 = ecdh.derive_public_planes(s1, curve)
    q2x, q2y, ok2 = ecdh.derive_public_planes(s2, curve)
    x12, ok12 = ecdh.shared_secret_planes(s1, q2x, q2y, curve)
    x21, ok21 = ecdh.shared_secret_planes(s2, q1x, q1y, curve)
    assert bool((ok1 & ok2 & ok12 & ok21).all()) and torch.equal(x12, x21)
    assert ints(x12[:, :8]) == [coz.scalar_mult_affine(a * b % n, curve.gx, curve.gy, curve)[0]
                                for a, b in zip(d1[:8], d2)]
    rng = np.random.default_rng(105)
    zs = [int.from_bytes(rng.bytes(48), "big") for _ in range(64)]
    ks, sk = _wide_scalars(curve, 64, 106, cuda)
    z = _wide_planes(zs, curve, cuda)
    r, s, ok = ecdsa.sign_planes(z, s1, sk, curve)
    assert bool(ok.all())
    for i in range(8):
        rx = coz.scalar_mult_affine(ks[i], curve.gx, curve.gy, curve)[0] % n
        assert (ints(r[:, i:i + 1])[0], ints(s[:, i:i + 1])[0]) == (
            rx, pow(ks[i], -1, n) * (zs[i] % n + rx * d1[i]) % n)
    assert bool(ecdsa.verify_planes(z, r, s, q1x, q1y, curve).all())
    found = torch.zeros(64, dtype=torch.bool, device=cuda)
    for v in (0, 1):
        qx, qy, okr = ecdsa.recover_planes(z, r, s, torch.full((64,), v, dtype=torch.int32,
                                                              device=cuda), curve)
        found |= okr.bool() & (qx == q1x).all(0) & (qy == q1y).all(0)
    assert bool(found.all())


# --- kernels B and the generic L: the table read on the tensor cores -------------------

MMA_CURVES = [P256, SECP256K1, WEI25519, P384, P521]


@pytest.mark.parametrize("strict", [False, True], ids=["plain", "strict"])
@pytest.mark.parametrize("curve", MMA_CURVES, ids=lambda c: c.name)
def test_comb_mma_kernels_match_plain(cuda, curve, strict):
    """Kernel B and the generic kernel L (chains 2; strict: one chain,
    unroll 2), which select their entries with u8 one-hot products on the
    tensor cores, against comb_plain / comb_chains_plain word for word on
    4,133 lanes (not a multiple of the 128-lane block): the first 160 lanes
    share one scalar, so whole warps pick one entry at every position, the
    rest are uniform mod n (edges 1, 2, 5, n - 2 first; strict: n - 1 on
    lane 4). Each is one launch of its kernel."""
    n, same = 4133, 160
    ks, _ = _wide_scalars(curve, n, 211, cuda, curve.order - 1 if strict else None)
    ks[5:5 + same] = [ks[5]] * same
    s = _wide_planes(ks, curve, cuda)
    tables, negbase, nb, mma = _comb_tables(curve, cuda)
    chains, unroll = (1, 2) if strict else (2, 1)
    b, l = comb.KERNELS[(curve, strict)], comb.KERNELS_GENERAL[(curve, strict)]
    before = (b.launches, l.launches)
    got_b = comb.comb_planes(s, mma, nb, curve, strict)
    got_l = comb.comb_general_planes(s, mma, nb, curve, chains, unroll, strict)
    assert (b.launches, l.launches) == (before[0] + 1, before[1] + 1)
    want_b = comb.comb_plain(s, tables, curve, negbase, strict)
    want_l = comb.comb_chains_plain(s, tables, curve, negbase, chains, unroll, strict)
    for k, w in (*zip(got_b, want_b), *zip(got_l, want_l)):
        assert torch.equal(k, w)
    for t in got_b:
        assert torch.equal(t[:, 5:5 + same], t[:, 5:6].expand(-1, same))


@pytest.mark.parametrize("curve", MMA_CURVES, ids=lambda c: c.name)
def test_comb_tree_pipe_mma_kernels(cuda, curve):
    """Kernels J and K, which select two entries a step (J) or entry j + 1
    beside the add of entry j (K) on the tensor cores, against
    comb_tree_plain / comb_plain word for word on 4,133 lanes, the first
    160 on one scalar (whole warps on one entry at every position), edges
    1, 2, 5, n - 2 first; one launch each. Their ``_smem`` queries give
    comb.tree_smem_bytes / pipe_smem_bytes and ``_blocks`` at least one
    block an SM; the limb table is refused, naming mma_tables."""
    n, same = 4133, 160
    ks, _ = _wide_scalars(curve, n, 212, cuda)
    ks[5:5 + same] = [ks[5]] * same
    s = _wide_planes(ks, curve, cuda)
    tables, negbase, nb, mma = _comb_tables(curve, cuda)
    j, k = comb.KERNELS_TREE[curve], comb.KERNELS_PIPE[curve]
    before = (j.launches, k.launches)
    got_j = comb.comb_tree_planes(s, mma, nb, curve)
    got_k = comb.comb_pipe_planes(s, mma, nb, curve)
    assert (j.launches, k.launches) == (before[0] + 1, before[1] + 1)
    want_j = comb.comb_tree_plain(s, tables, curve, negbase)
    want_k = comb.comb_plain(s, tables, curve, negbase)
    for got, want in (*zip(got_j, want_j), *zip(got_k, want_k)):
        assert torch.equal(got, want)
    torch.cuda.synchronize()
    lib = _build.library().lib
    for kernel, size in ((j, comb.tree_smem_bytes(curve)), (k, comb.pipe_smem_bytes(curve))):
        smem, blocks = (getattr(lib, f"{kernel.symbol}_{q}") for q in ("smem", "blocks"))
        for fn in (smem, blocks):
            fn.argtypes, fn.restype = [], ctypes.c_int
        assert smem() == size and blocks() >= 1, kernel.symbol
    limbs = torch.from_numpy(comb.limb_layout(comb.base_tables(curve, curve.gx, curve.gy)[0]))
    limbs = limbs.to(cuda)
    for wrapper in (comb.comb_tree_planes, comb.comb_pipe_planes):
        with pytest.raises(ValueError, match="mma_tables"):
            wrapper(s, limbs, nb, curve)


ALL_CURVES = [P256, SECP256K1, WEI25519, P384, P521]


@pytest.mark.parametrize("size", ["small", "large"])
@pytest.mark.parametrize("curve", ALL_CURVES, ids=lambda c: c.name)
def test_affine_batch_inversion_edges(cuda, curve, size):
    """Kernel D's batch inversion on a ragged batch (3 blocks and 37 lanes
    when small; as many blocks as the card has SMs and 37 lanes when
    large, so that it runs the curve's own lanes a thread G, not the small
    batch's) with z = 0 at every position of a group (thread j of block 1
    at its lane j, j < G), a whole group (thread G), a group's first and
    last lanes (thread G + 1), a warp's edge (threads 31 and 32 of block
    2) and the batch's last lane: word for word against
    JacobianPoint.to_affine, one launch, and the first 16 lanes ((i+1)G,
    random z) against the oracle."""
    threads, group_, _ = affine.layout(curve, 1 if size == "small" else 1 << 30)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    n = (3 if size == "small" else max(3, sms)) * threads * group_ + 37
    assert affine.layout(curve, n)[1] == group_
    p, fs = curve.p, curve.field
    rng = np.random.default_rng(130)
    nbytes = (p.bit_length() + 7) // 8 + 8
    zs = [int.from_bytes(rng.bytes(nbytes), "little") % (p - 1) + 1 for _ in range(n)]
    pts = multiples(curve, 16)
    xs = [x * z * z % p for (x, _), z in zip(pts, zs)] + [
        int.from_bytes(rng.bytes(nbytes), "little") % p for _ in range(n - 16)]
    ys = [y * z * z * z % p for (_, y), z in zip(pts, zs)] + [
        int.from_bytes(rng.bytes(nbytes), "little") % p for _ in range(n - 16)]
    block = threads * group_  # block 1 from lane `block`
    zero = {block + j + j * threads for j in range(group_)}  # position j of thread j's group
    zero |= {block + group_ + j * threads for j in range(group_)}  # thread G: a whole group
    zero |= {block + group_ + 1, block + group_ + 1 + (group_ - 1) * threads}  # first, last
    zero |= {2 * block + 31, 2 * block + 32, n - 1}
    for i in zero:
        zs[i] = 0
    x, y, z = (GFp.from_classical(_wide_planes(v, curve, cuda), fs).planes.contiguous()
               for v in (xs, ys, zs))
    kernel = affine.KERNELS[curve]
    before = kernel.launches
    got = affine.affine_planes(x, y, z, curve)
    assert kernel.launches == before + 1
    want = JacobianPoint(GFp(x, fs), GFp(y, fs), GFp(z, fs), curve).to_affine()
    assert torch.equal(got[0], want.x) and torch.equal(got[1], want.y)
    assert not any(bool(g[:, sorted(zero)].any()) for g in got)
    assert list(zip(ints(got[0][:, :16]), ints(got[1][:, :16]))) == pts


@pytest.mark.parametrize("curve", ALL_CURVES, ids=lambda c: c.name)
def test_ladder_kernel_edge_scalars_all_curves(cuda, curve):
    """Kernel A at its register budget on 256 lanes with scalars 1, 2, 5,
    n - 2 and n - 1 first, word for word against the plain
    group.scalar_mult, one launch, and 16 lanes against the oracle (n - 1,
    outside the ladder's domain: against the plain ladder only)."""
    ks, s = _wide_scalars(curve, 256, 131, cuda, curve.order - 1)
    pts, pt = _wide_points(curve, 256, cuda)
    kernel = ladder.KERNELS[curve]
    before = kernel.launches
    got = ladder.scalar_mult(s, pt)
    assert kernel.launches == before + 1
    xm = GFp.from_classical(pt.x, curve.field)
    ym = GFp.from_classical(pt.y, curve.field)
    want = group.scalar_mult(s, JacobianPoint(xm, ym, GFp.one(curve.field, xm.planes), curve))
    for k, w in zip((got.x, got.y, got.z), (want.x, want.y, want.z)):
        assert torch.equal(k.planes, w.planes)
    out = affine.to_affine(got)
    lanes = [i for i in range(16) if i != 4]
    got16 = list(zip(ints(out.x[:, :16]), ints(out.y[:, :16])))
    want16 = _curve_oracle(ks[:16], pts[:16], curve)
    assert [got16[i] for i in lanes] == [want16[i] for i in lanes]
