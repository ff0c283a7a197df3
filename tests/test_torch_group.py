"""The port's group law (ecsimd_tpu_torch.curves.group) against the JAX
package — curves/group.py's formulas and kernels/coz.py's fused ZDAU /
ADD_Z2_1 / dbl-2001-b / general and complete adds, run eagerly on the
kernels' digit-list field element (VGFp) — and against the Python-int
oracle, on P-256 and on the 4-digit toy curve TOY64. Tolerance: exact."""

import jax.numpy as jnp
import numpy as np
import pytest

from ecsimd_tpu.curves import group as jgroup
from ecsimd_tpu.curves.point import JacobianPoint as JJacobian
from ecsimd_tpu.field import GFp as JGFp
from ecsimd_tpu.kernels import coz as jcoz
from ecsimd_tpu.kernels.digits import VGFp
from ecsimd_tpu.oracle import coz as ocoz
from ecsimd_tpu.oracle import window as ow
from ecsimd_tpu.specs import P256
from ecsimd_tpu_torch.curves import group as tgroup
from ecsimd_tpu_torch.curves.point import AffinePoint, JacobianPoint
from ecsimd_tpu_torch.field import GFp
from tests.toy import TOY64, TOYA5S
from tests.torch_helpers import ints, multiples, planes, port_spec, rand_ints, tplanes

TP256 = port_spec(P256)
FS = TP256.field
D = FS.ndigits
N = 8


def _t(vals, fs=FS):
    return GFp(tplanes(vals, fs.ndigits), fs)


def _v(vals, fs=P256.field):
    return VGFp([jnp.asarray(r) for r in planes(vals, fs.ndigits)], fs)


def _same(port, jax_outs, oracle_cols=None):
    for k, (t, j) in enumerate(zip(port, jax_outs)):
        got = ints(t.planes)
        want = ints(jnp.stack(j.digs)) if isinstance(j, VGFp) else ints(j.planes)
        assert got == want, f"output {k} vs JAX"
        if oracle_cols is not None:
            assert got == oracle_cols[k], f"output {k} vs oracle"


@pytest.fixture(scope="module")
def pts():
    return multiples(P256, 2 * N)


def test_dblu_zaddu_tplu(pts):
    xs, ys = [x for x, _ in pts[:N]], [y for _, y in pts[:N]]
    want = [ocoz.dblu((x, y, 1), P256) for x, y in pts[:N]]
    cols = [[w[0][0] for w in want], [w[0][1] for w in want], [w[1][0] for w in want],
            [w[1][1] for w in want], [w[0][2] for w in want]]
    _same(tgroup.dblu(_t(xs), _t(ys), TP256), jgroup.dblu(_v(xs), _v(ys), P256), cols)

    want = [ocoz.tplu((x, y, 1), P256) for x, y in pts[:N]]
    cols = [[w[0][0] for w in want], [w[0][1] for w in want], [w[1][0] for w in want],
            [w[1][1] for w in want], [w[0][2] for w in want]]
    _same(tgroup.tplu(_t(xs), _t(ys), TP256), jgroup.tplu(_v(xs), _v(ys), P256), cols)


def test_zdau(pts):
    # co-Z inputs: (3P, P') from the oracle's TPLU
    seeds = [ocoz.tplu((x, y, 1), P256) for x, y in pts[:N]]
    x1 = [s[0][0] for s in seeds]
    y1 = [s[0][1] for s in seeds]
    x2 = [s[1][0] for s in seeds]
    y2 = [s[1][1] for s in seeds]
    z = [s[0][2] for s in seeds]
    want = [ocoz.zdau(s[0], s[1], P256) for s in seeds]
    cols = [[w[0][0] for w in want], [w[0][1] for w in want], [w[1][0] for w in want],
            [w[1][1] for w in want], [w[0][2] for w in want]]
    port = tgroup.zdau(_t(x1), _t(y1), _t(x2), _t(y2), _t(z))
    _same(port, jcoz.zdau_fused(_v(x1), _v(y1), _v(x2), _v(y2), _v(z)), cols)
    _same(port, jgroup.zdau(_v(x1), _v(y1), _v(x2), _v(y2), _v(z)), cols)


def test_add_z2_1(pts):
    seeds = [ocoz.tplu((x, y, 1), P256)[0] for x, y in pts[:N]]  # 3P with z != 1
    x1, y1, z1 = ([s[k] for s in seeds] for k in range(3))
    x2, y2 = [x for x, _ in pts[N:]], [y for _, y in pts[N:]]
    want = [ocoz.add_z2_1(s, (x, y, 1), P256) for s, (x, y) in zip(seeds, pts[N:])]
    cols = [[w[k] for w in want] for k in range(3)]
    port = tgroup.add_z2_1(_t(x1), _t(y1), _t(z1), _t(x2), _t(y2))
    _same(port, jcoz.add_z2_1_fused(_v(x1), _v(y1), _v(z1), _v(x2), _v(y2)), cols)
    _same(port, jgroup.add_z2_1(_v(x1), _v(y1), _v(z1), _v(x2), _v(y2)), cols)


def test_points_affine_round_trip(pts):
    xs, ys = [x for x, _ in pts[:N]], [y for _, y in pts[:N]]
    jac = JacobianPoint.from_affine(AffinePoint(tplanes(xs, D), tplanes(ys, D), TP256))
    assert ints(jac.z.planes) == [1] * N
    neg = jac.opposite()
    assert ints(neg.y.planes) == [(-y) % P256.p for y in ys]
    # a Jacobian point with z != 1 back to affine
    tripled = [ocoz.tplu((x, y, 1), P256)[0] for x, y in pts[:N]]
    j3 = JacobianPoint(*(_t([t[k] for t in tripled]) for k in range(3)), TP256)
    aff = j3.to_affine()
    assert list(zip(ints(aff.x), ints(aff.y))) == [
        ocoz.jacobian_to_affine(t, P256) for t in tripled]


# --- free-standing Jacobian doubling, general and complete adds ----------------


def _jacobian(curve, aff, seed):
    """Affine points as Jacobian (x z^2, y z^3, z) with seeded z != 0, 1."""
    p = curve.p
    zs = [z + 2 for z in rand_ints(np.random.default_rng(seed), p - 2, len(aff))]
    return [(x * z * z % p, y * z * z * z % p, z) for (x, y), z in zip(aff, zs)]


def _cols(jacs):
    return [[j[k] for j in jacs] for k in range(3)]


@pytest.mark.parametrize("curve", [TOY64, P256], ids=lambda c: c.name)
def test_dbl_and_add_match_jax_coz(curve):
    """dbl_am3 and jac_add against kernels/coz.py's jac_dbl / jac_add (both
    with the (h, r) outputs), the oracle's Jacobian formulas, and — for the
    doubling — the general-a dbl-2007-bl jac_dbl, which gives the same
    values for a = -3 (X3 = M^2 - 8XY^2, Z3 = 2YZ)."""
    tc, fs = port_spec(curve), curve.field
    aff = multiples(curve, 2 * N)
    p1, p2 = _jacobian(curve, aff[:N], 70), _jacobian(curve, aff[N:], 71)
    t1 = [_t(c, tc.field) for c in _cols(p1)]
    t2 = [_t(c, tc.field) for c in _cols(p2)]
    v1 = [_v(c, fs) for c in _cols(p1)]
    v2 = [_v(c, fs) for c in _cols(p2)]

    dbl = tgroup.dbl_am3(*t1, tc)
    _same(dbl, jcoz.jac_dbl(*v1, curve), _cols([ow._jac_dbl(q, curve) for q in p1]))
    _same(dbl, tgroup.jac_dbl(*t1, tc))

    add = tgroup.jac_add(*t1, *t2, with_hr=True)
    _same(add, jcoz.jac_add(*v1, *v2, with_hr=True))
    _same(add[:3], jcoz.jac_add(*v1, *v2), _cols([ow._jac_add(a, b, curve) for a, b in zip(p1, p2)]))


def test_general_a_doubling_raises_in_window_formulas():
    tc = port_spec(TOYA5S)
    one = _t([1], tc.field)
    with pytest.raises(NotImplementedError, match="ROADMAP B0"):
        tgroup.dbl_am3(one, one, one, tc)


@pytest.mark.parametrize("curve", [TOY64, P256], ids=lambda c: c.name)
def test_complete_adds_resolve_degenerate_cases(curve):
    """Lanes: A + B generic, A + A (doubling), A + (-A) (infinity, z = 0),
    inf + B (B). add_complete against kernels/coz.add_complete_any and
    jac_add_complete against curves/group.jac_add_complete, bit for bit;
    both against the oracle. A has z != 1; B is affine (z = 1), as the
    window's fix-up and the comb's entries are. The JAX GFp twin runs on
    TOY64 only (its eager P-256 ops compile for seconds each); on P-256
    jac_add_complete is held to add_complete, which is held to coz."""
    tc, fs, p = port_spec(curve), curve.field, curve.p
    aff = multiples(curve, 7)
    a, b = _jacobian(curve, [aff[4]], 72)[0], aff[6]
    neg_a = (a[0], (p - a[1]) % p, a[2])
    lane1 = [a, a, a, (1, 1, 0)]
    lane2 = [(*b, 1), a, neg_a, (*b, 1)]
    t1 = [_t(c, tc.field) for c in _cols(lane1)]
    t2 = [_t(c, tc.field) for c in _cols(lane2)]

    port = tgroup.add_complete(*t1, *t2, tc)
    _same(port, jcoz.add_complete_any(*(_v(c, fs) for c in _cols(lane1)),
                                      *(_v(c, fs) for c in _cols(lane2)), curve))
    full = tgroup.jac_add_complete(JacobianPoint(*t1, tc), JacobianPoint(*t2, tc))
    _same((full.x, full.y, full.z), port)
    if curve is TOY64:
        j1, j2 = (JJacobian(*(JGFp(jnp.asarray(planes(c, fs.ndigits)), fs) for c in _cols(lane)),
                            curve) for lane in (lane1, lane2))
        ref = jgroup.jac_add_complete(j1, j2)
        _same((full.x, full.y, full.z), (ref.x, ref.y, ref.z))

    x3, y3, z3 = (ints(t.planes) for t in port)
    assert ocoz.jacobian_to_affine((x3[0], y3[0], z3[0]), curve) == ow.scalar_mult_affine(
        12, curve.gx, curve.gy, curve)  # 5G + 7G
    assert ocoz.jacobian_to_affine((x3[1], y3[1], z3[1]), curve) == ow.scalar_mult_affine(
        10, curve.gx, curve.gy, curve)  # 2 * 5G
    assert z3[2] == 0  # A + (-A) = infinity
    assert (x3[3], y3[3], z3[3]) == (*b, 1)  # inf + B = B
