"""The port's own copies of the JAX package's framework-free modules —
specs, convert, oracle — against the originals. Tolerance: exact."""

import dataclasses

import numpy as np
import pytest

from ecsimd_tpu import convert as jconvert
from ecsimd_tpu import specs as jspecs
from ecsimd_tpu.oracle import coz as jcoz
from ecsimd_tpu.oracle import window as jwindow
from ecsimd_tpu_torch import convert as tconvert
from ecsimd_tpu_torch import glv as tglv
from ecsimd_tpu_torch import specs as tspecs
from ecsimd_tpu_torch.oracle import coz as tcoz
from ecsimd_tpu_torch.oracle import window as twindow
from tests.toy import TOY64, TOY64E, TOYGLV
from tests.torch_helpers import port_spec, rand_ints

FIELD_CONSTS = ("plain", "ndigits", "R", "R_mod_p", "R2_mod_p", "R_inv", "mprime", "p_digits",
                "fermat_exponent", "sqrt_kind")


def _field_equal(t, j):
    assert type(t) is tspecs.FieldSpec and type(j) is jspecs.FieldSpec
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    for name in FIELD_CONSTS:
        assert getattr(t, name) == getattr(j, name), name
    assert t.R2_digits() == j.R2_digits()
    if j.sqrt_kind == "p3mod4":
        assert t.sqrt_exponent == j.sqrt_exponent
    elif j.sqrt_kind == "p5mod8":
        assert t.sqrt_m1 == j.sqrt_m1
    else:
        assert t.ts_params == j.ts_params


def test_curves_and_fields_equal_the_reference():
    assert tspecs.DIGIT_BITS == jspecs.DIGIT_BITS and tspecs.DIGIT_MASK == jspecs.DIGIT_MASK
    assert sorted(tspecs.CURVES) == sorted(jspecs.CURVES)
    assert sorted(tspecs.FIELDS) == sorted(jspecs.FIELDS)
    for name, f in jspecs.FIELDS.items():
        _field_equal(tspecs.FIELDS[name], f)
    for name, c in jspecs.CURVES.items():
        t = tspecs.CURVES[name]
        assert type(t) is tspecs.CurveSpec
        _field_equal(t.field, c.field)
        for k in ("name", "a", "b", "gx", "gy", "order", "order_exact", "p", "am3"):
            assert getattr(t, k) == getattr(c, k), (name, k)
        # the two packages' specs are distinct types: never equal
        assert t != c and port_spec(c) == t
    assert tspecs.int_to_digits(12345678901234567890, 8) == jspecs.int_to_digits(
        12345678901234567890, 8)
    assert tspecs.digits_to_int((1, 2, 3)) == jspecs.digits_to_int((1, 2, 3))


@pytest.mark.parametrize("curve", [TOY64, TOY64E, TOYGLV], ids=lambda c: c.name)
def test_port_spec_rebuilds_test_curves(curve):
    t = port_spec(curve)
    assert type(t) is tspecs.CurveSpec and t != curve
    assert dataclasses.asdict(t) == dataclasses.asdict(curve)
    assert tglv.glv_capable(t) == (curve is TOYGLV)


def test_convert_equals_the_reference():
    rng = np.random.default_rng(80)
    for d in (4, 16):
        vals = rand_ints(rng, 1 << (16 * d), 9, edges=[0, 1, (1 << (16 * d)) - 1])
        pl = tconvert.ints_to_planes(vals, d)
        np.testing.assert_array_equal(pl, jconvert.ints_to_planes(vals, d))
        assert tconvert.planes_to_ints(pl) == jconvert.planes_to_ints(pl) == vals
        np.testing.assert_array_equal(tconvert.broadcast_int(vals[3], d, 5),
                                      jconvert.broadcast_int(vals[3], d, 5))


def test_oracle_equals_the_reference():
    tc, jc = tspecs.P256, jspecs.P256
    n = jc.order
    for k in [1, 2, 5, n - 2, 0xDEADBEEF12345678, n // 3]:
        assert tcoz.scalar_mult_affine(k, tc.gx, tc.gy, tc) == jcoz.scalar_mult_affine(
            k, jc.gx, jc.gy, jc)
        assert twindow.recode(k, 256) == jwindow.recode(k, 256)
        if k == n - 2:  # a degenerate add for the window oracle: both raise
            for mod, c in ((twindow, tc), (jwindow, jc)):
                with pytest.raises(ZeroDivisionError):
                    mod.scalar_mult_affine(k, c.gx, c.gy, c)
            continue
        want = jwindow.scalar_mult_affine(k, jc.gx, jc.gy, jc)
        assert twindow.scalar_mult_affine(k, tc.gx, tc.gy, tc) == want
