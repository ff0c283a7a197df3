"""P-384 and P-521 through the port's plain entry points on CPU tensors,
against the JAX package's Python-int oracle (``ecsimd_tpu.oracle.coz``,
``oracle.ecdsa``) — what the JAX package's own tests on these curves hold
its results to (tests/test_p384.py, tests/test_more_curves.py) — and the
comb's host tables, the one state the port carries over, against the JAX
package's.

On CUDA tensors the same entry points run kernels A, B, D and E
(tests/test_torch_cuda.py and chip_smoke.py phase 19 hold them to these
plain versions). Plain PyTorch at these widths costs 3-26 s a call on the
CPU at any lane count (per-operation overhead: 384 and 528 ladder steps,
96 and 132 windows), so tier-1 runs the comb both ways on both curves, the
ladder and ECDH on P-384 (its shared secret through the strict window); the
rest is marked ``slow``: the ladder, the window and ECDH on P-521, the
plain window and ``scalar_mult_shared_fast`` on P-384, P-384 ECDSA, and one
comparison per curve with the JAX package's own XLA comb (an XLA:CPU
compile of minutes). ECDSA on P-521 is refused by both packages (ROADMAP
C7). At most 4 lanes a call; inputs from numpy seeds. Tolerance: exact.
"""

import numpy as np
import pytest
import torch

from ecsimd_tpu import ecdsa as jecdsa
from ecsimd_tpu.kernels import comb as jcomb
from ecsimd_tpu.oracle import coz as ocoz
from ecsimd_tpu.oracle import ecdsa as oecdsa
from ecsimd_tpu.specs import P384 as JP384
from ecsimd_tpu.specs import P521 as JP521
from ecsimd_tpu_torch import api, ecdh, ecdsa
from ecsimd_tpu_torch.curves.point import AffinePoint
from ecsimd_tpu_torch.kernels import comb
from ecsimd_tpu_torch.specs import P384, P521
from tests.torch_helpers import ints, multiples, rand_ints, tplanes

CURVES = {"P-384": (P384, JP384), "P-521": (P521, JP521)}


def _want(k, x, y, curve):
    """k (x, y) on ints: infinity as (0, 0), (n - 1) P = -P."""
    k %= curve.order
    if k == 0:
        return (0, 0)
    if k == curve.order - 1:
        return (x, (curve.field.p - y) % curve.field.p)
    return ocoz.scalar_mult_affine(k, x, y, curve)


def _affine(pt):
    return list(zip(ints(pt.x), ints(pt.y)))


def _points(name, n):
    """Affine (i+1)G for i < n: the port's planes, and the ints."""
    curve, jcurve = CURVES[name]
    d = curve.field.ndigits
    pts = multiples(jcurve, n)
    return AffinePoint(tplanes([x for x, _ in pts], d), tplanes([y for _, y in pts], d),
                       curve), pts


# --- the comb's carried state: host tables and their limb layout ---------------


@pytest.mark.parametrize("name", sorted(CURVES))
def test_comb_tables_and_limb_layout(name):
    """The port's comb tables equal the JAX package's host tables (npos =
    48 and 66 positions of 256 entries, 2D digit rows); kernel B's limb
    layout holds each kept entry's x then y as 32-bit limbs (P-521's last
    limb one digit), zero-padded to 12 / 20 words a coordinate."""
    curve, jcurve = CURVES[name]
    d = curve.field.ndigits
    tables, negbase = comb.base_tables(curve, curve.gx, curve.gy)
    jtables, jneg = jcomb.base_tables(jcurve, jcurve.gx, jcurve.gy)
    np.testing.assert_array_equal(tables, np.asarray(jtables))
    assert tuple(negbase) == tuple(jneg)
    limbs = comb.limb_layout(tables)
    w = comb.coord_words(d)
    npos = curve.field.nbits // comb.W
    assert limbs.shape == (comb.NENT + (npos - 1) * comb.NENT // 2, 2 * w)
    assert (w, npos) == {24: (12, 48), 33: (20, 66)}[d]

    def digits_value(row):
        return sum(int(v) << (16 * j) for j, v in enumerate(row))

    def limbs_value(row):
        return sum((int(v) & 0xFFFFFFFF) << (32 * j) for j, v in enumerate(row))

    # position 0 whole, then positions 1, 2 and the last: entries 128 .. 255
    rows = [(0, e, e) for e in range(comb.NENT)]
    for i in (1, 2, npos - 1):
        base = comb.NENT + (i - 1) * comb.NENT // 2
        rows += [(i, comb.NENT // 2 + m, base + m) for m in range(comb.NENT // 2)]
    for i, e, r in rows:
        assert limbs_value(limbs[r, :w]) == digits_value(tables[i, e, :d])
        assert limbs_value(limbs[r, w:]) == digits_value(tables[i, e, d:])
    pad = (d + 1) // 2
    assert not limbs[:, pad:w].any() and not limbs[:, w + pad:].any()


# --- the entry points against the oracle -----------------------------------------


@pytest.mark.parametrize("strict", [False, True], ids=["plain", "strict"])
@pytest.mark.parametrize("name", sorted(CURVES))
def test_scalar_mult_base_vs_oracle(name, strict):
    """api.scalar_mult_base (the serial comb, kernel B's plain version): k =
    1, 2, a draw, and n - 1 (strict: -G) or n - 2."""
    curve, jcurve = CURVES[name]
    n = curve.order
    ks = [1, 2, rand_ints(np.random.default_rng(390 + strict), n - 3, 1)[0] + 2,
          n - 1 if strict else n - 2]
    out = api.scalar_mult_base(tplanes(ks, curve.field.ndigits), curve, strict=strict)
    assert _affine(out) == [_want(k, jcurve.gx, jcurve.gy, jcurve) for k in ks]


def _ladder_case(name):
    curve, jcurve = CURVES[name]
    n, d = curve.order, curve.field.ndigits
    ks = [1, 2, n - 2, rand_ints(np.random.default_rng(391), n - 3, 1)[0] + 2]
    pt, pts = _points(name, len(ks))
    out = api.scalar_mult(tplanes(ks, d), pt)
    assert _affine(out) == [_want(k, x, y, jcurve) for k, (x, y) in zip(ks, pts)]


def test_scalar_mult_ladder_vs_oracle_p384():
    """api.scalar_mult (the co-Z ladder, kernel A's plain version, 384
    steps) on points (i+1)G: k = 1, 2, n - 2 and a draw."""
    _ladder_case("P-384")


@pytest.mark.slow
def test_scalar_mult_ladder_vs_oracle_p521():
    """The same on P-521: 528 steps, the seven bits above the order's 521
    included (~30 s on the CPU)."""
    _ladder_case("P-521")


def _window_case(name, strict, shared=False):
    curve, jcurve = CURVES[name]
    n, d = curve.order, curve.field.ndigits
    ks = [1, 2, n - 1 if strict else 5, rand_ints(np.random.default_rng(392), n - 3, 1)[0] + 2]
    pt, pts = _points(name, len(ks))
    if shared:
        out = api.scalar_mult_shared_fast(ks[3], pt)
        ks = [ks[3]] * len(ks)
    else:
        out = api.scalar_mult_fast(tplanes(ks, d), pt, strict=strict)
    assert _affine(out) == [_want(k, x, y, jcurve) for k, (x, y) in zip(ks, pts)]


@pytest.mark.slow
@pytest.mark.parametrize("strict", [False, True], ids=["plain", "strict"])
@pytest.mark.parametrize("name", sorted(CURVES))
def test_scalar_mult_fast_vs_oracle(name, strict):
    """api.scalar_mult_fast (the signed window, kernel E's plain version:
    96 and 132 windows) on points (i+1)G; strict takes k = n - 1 (-P)."""
    _window_case(name, strict)


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(CURVES))
def test_scalar_mult_shared_fast_vs_oracle(name):
    _window_case(name, False, shared=True)


def _ecdh_case(name):
    curve, jcurve = CURVES[name]
    n, d = curve.order, curve.field.ndigits
    rng = np.random.default_rng(393)
    ds = [k + 1 for k in rand_ints(rng, n - 1, 3)] + [0]  # lane 3: a zero scalar
    es = [k + 1 for k in rand_ints(rng, n - 1, 4)]
    qx, qy, okq = ecdh.derive_public_planes(tplanes(es, d), curve)
    want_q = [ocoz.scalar_mult_affine(e, jcurve.gx, jcurve.gy, jcurve) for e in es]
    assert list(zip(ints(qx), ints(qy))) == want_q and okq.tolist() == [1] * 4
    qy = qy.clone()
    qy[:, 2] ^= 1  # lane 2: a peer off the curve
    x, ok = ecdh.shared_secret_planes(tplanes(ds, d), qx, qy, curve)
    assert ok.tolist() == [1, 1, 0, 0]
    got = ints(x)
    for i in (0, 1):
        assert got[i] == ocoz.scalar_mult_affine(ds[i] * es[i] % n, jcurve.gx, jcurve.gy,
                                                 jcurve)[0]


def test_ecdh_vs_oracle_p384():
    """ECDH on P-384: two parties' keys (the comb), the shared secret (the
    strict window) with a zero scalar and an off-curve peer; masks exact,
    x exact on the valid lanes."""
    _ecdh_case("P-384")


@pytest.mark.slow
def test_ecdh_vs_oracle_p521():
    _ecdh_case("P-521")


@pytest.mark.slow
def test_ecdsa_p384_sign_verify_recover_vs_oracle():
    """P-384 ECDSA (SHA-384-sized z: 384-bit planes): sign against the
    oracle's (r, s), verify of the honest and a tampered lane, recover
    with the oracle's recovery id."""
    curve, jcurve = P384, JP384
    n, d = curve.order, curve.field.ndigits
    rng = np.random.default_rng(394)
    zs = rand_ints(rng, 1 << 384, 2)
    ds = [k + 1 for k in rand_ints(rng, n - 1, 2)]
    ks = [k + 1 for k in rand_ints(rng, n - 1, 2)]
    r, s, ok = ecdsa.sign_planes(tplanes(zs, d), tplanes(ds, d), tplanes(ks, d), curve)
    want = [oecdsa.sign(z, dd, k, jcurve) for z, dd, k in zip(zs, ds, ks)]
    assert list(zip(ints(r), ints(s))) == want and ok.tolist() == [1, 1]
    qs = [oecdsa.keypair(dd, jcurve) for dd in ds]
    rs = [r_ for r_, _ in want]
    ss = [s_ for _, s_ in want]
    rs_bad = [rs[0], (rs[1] + 1) % n]
    valid = ecdsa.verify_planes(tplanes(zs, d), tplanes(rs_bad, d), tplanes(ss, d),
                                tplanes([q[0] for q in qs], d), tplanes([q[1] for q in qs], d),
                                curve)
    assert valid.tolist() == [int(oecdsa.verify(z, r_, s_, qx, qy, jcurve))
                              for z, r_, s_, (qx, qy) in zip(zs, rs_bad, ss, qs)] == [1, 0]
    vs = [oecdsa.sign_recoverable(z, dd, k, jcurve)[2] for z, dd, k in zip(zs, ds, ks)]
    qx, qy, okr = ecdsa.recover_planes(tplanes(zs, d), tplanes(rs, d), tplanes(ss, d),
                                       torch.tensor(vs, dtype=torch.int32), curve)
    assert list(zip(ints(qx), ints(qy))) == qs and okr.tolist() == [1, 1]


def test_ecdsa_refused_on_p521():
    """ROADMAP C7, the reference's behaviour: both packages refuse ECDSA on
    P-521, whose n has 521 bits where the planes hold 528 (a hash is
    reduced mod n by one conditional subtract, so 2n > 2^528 is needed)."""
    d = P521.field.ndigits
    assert not jecdsa.curve_order_big_enough(jecdsa.order_field(JP521))
    assert not ecdsa.curve_order_big_enough(ecdsa.order_field(P521))
    one = tplanes([1], d)
    with pytest.raises(AssertionError):
        ecdsa.verify_planes(one, one, one, tplanes([P521.gx], d), tplanes([P521.gy], d), P521)
    with pytest.raises(AssertionError):
        jecdsa.verify_planes(one.numpy(), one.numpy(), one.numpy(),
                             tplanes([P521.gx], d).numpy(), tplanes([P521.gy], d).numpy(), JP521)


# --- against the JAX package's own XLA function ----------------------------------


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(CURVES))
def test_comb_tree_matches_jax_xla(name):
    """The port's comb through the tree (CPU tensors) against the JAX
    package's XLA comb with the same schedule (``comb.scalar_mult_base(...,
    use_kernel=False, chain="tree")``, as tests/test_p384.py runs it), plane
    for plane."""
    curve, jcurve = CURVES[name]
    n, d = curve.order, curve.field.ndigits
    ks = [1, 2, n - 2, rand_ints(np.random.default_rng(395), n - 3, 1)[0] + 2]
    got = comb.scalar_mult_base(tplanes(ks, d), curve, chain="tree")
    from ecsimd_tpu import api as japi
    want = jcomb.scalar_mult_base(japi.scalars_from_ints(ks, jcurve), jcurve,
                                  use_kernel=False, chain="tree")
    for t, j in zip((got.x, got.y, got.z), (want.x, want.y, want.z)):
        np.testing.assert_array_equal(t.planes.numpy(), np.asarray(j.planes))
