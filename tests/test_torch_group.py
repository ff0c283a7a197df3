"""The port's co-Z group law (ecsimd_tpu_torch.curves.group) on P-256
against the JAX package — curves/group.py's formulas and kernels/coz.py's
fused ZDAU / ADD_Z2_1, both run eagerly on the kernels' digit-list field
element (VGFp) — and against the Python-int oracle. Tolerance: exact."""

import jax.numpy as jnp
import pytest

from ecsimd_tpu.curves import group as jgroup
from ecsimd_tpu.kernels import coz as jcoz
from ecsimd_tpu.kernels.digits import VGFp
from ecsimd_tpu.oracle import coz as ocoz
from ecsimd_tpu.specs import P256
from ecsimd_tpu_torch.curves import group as tgroup
from ecsimd_tpu_torch.curves.point import AffinePoint, JacobianPoint
from ecsimd_tpu_torch.field import GFp
from tests.torch_helpers import ints, multiples, planes, tplanes

FS = P256.field
D = FS.ndigits
N = 8


def _t(vals):
    return GFp(tplanes(vals, D), FS)


def _v(vals):
    return VGFp([jnp.asarray(r) for r in planes(vals, D)], FS)


def _same(port, jax_outs, oracle_cols):
    for k, (t, j) in enumerate(zip(port, jax_outs)):
        got = ints(t.planes)
        assert got == ints(jnp.stack(j.digs)), f"output {k} vs JAX"
        assert got == oracle_cols[k], f"output {k} vs oracle"


@pytest.fixture(scope="module")
def pts():
    return multiples(P256, 2 * N)


def test_dblu_zaddu_tplu(pts):
    xs, ys = [x for x, _ in pts[:N]], [y for _, y in pts[:N]]
    want = [ocoz.dblu((x, y, 1), P256) for x, y in pts[:N]]
    cols = [[w[0][0] for w in want], [w[0][1] for w in want], [w[1][0] for w in want],
            [w[1][1] for w in want], [w[0][2] for w in want]]
    _same(tgroup.dblu(_t(xs), _t(ys), P256), jgroup.dblu(_v(xs), _v(ys), P256), cols)

    want = [ocoz.tplu((x, y, 1), P256) for x, y in pts[:N]]
    cols = [[w[0][0] for w in want], [w[0][1] for w in want], [w[1][0] for w in want],
            [w[1][1] for w in want], [w[0][2] for w in want]]
    _same(tgroup.tplu(_t(xs), _t(ys), P256), jgroup.tplu(_v(xs), _v(ys), P256), cols)


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
    jac = JacobianPoint.from_affine(AffinePoint(tplanes(xs, D), tplanes(ys, D), P256))
    assert ints(jac.z.planes) == [1] * N
    neg = jac.opposite()
    assert ints(neg.y.planes) == [(-y) % P256.p for y in ys]
    # a Jacobian point with z != 1 back to affine
    tripled = [ocoz.tplu((x, y, 1), P256)[0] for x, y in pts[:N]]
    j3 = JacobianPoint(*(_t([t[k] for t in tripled]) for k in range(3)), P256)
    aff = j3.to_affine()
    assert list(zip(ints(aff.x), ints(aff.y))) == [
        ocoz.jacobian_to_affine(t, P256) for t in tripled]
