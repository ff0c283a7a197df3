"""The port's own copies of the JAX package's framework-free modules —
specs, convert, oracle — against the originals. Tolerance: exact."""

import dataclasses

import numpy as np
import pytest

from ecsimd_tpu import convert as jconvert
from ecsimd_tpu import specs as jspecs
from ecsimd_tpu import ecdsa as jecdsa
from ecsimd_tpu import glv as jglv
from ecsimd_tpu.oracle import coz as jcoz
from ecsimd_tpu.oracle import field as jfield
from ecsimd_tpu.oracle import window as jwindow
from ecsimd_tpu_torch import convert as tconvert
from ecsimd_tpu_torch import ecdsa as tecdsa
from ecsimd_tpu_torch import glv as tglv
from ecsimd_tpu_torch import specs as tspecs
from ecsimd_tpu_torch.oracle import coz as tcoz
from ecsimd_tpu_torch.oracle import field as tfield
from ecsimd_tpu_torch.oracle import window as twindow
from tests.toy import GLV32, MONT64, TOY64, TOY64E, TOYGLV, TS64
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


@pytest.mark.parametrize("d", [4, 16, 33])
def test_byte_packers_equal_the_reference(d):
    """bytes <-> planes and 64-bit limbs -> planes: the port's numpy paths
    against the JAX package's (its native packer where it is built)."""
    rng = np.random.default_rng(81 + d)
    vals = rand_ints(rng, 1 << (16 * d), 7, edges=[0, 1, (1 << (16 * d)) - 1, 0xFF00FF])
    pl = tconvert.ints_to_planes(vals, d)
    raw = tconvert.planes_to_bytes_be(pl)
    assert raw == jconvert.planes_to_bytes_be(pl)
    assert raw == b"".join(v.to_bytes(2 * d, "big") for v in vals)
    np.testing.assert_array_equal(tconvert.bytes_be_to_planes(raw, d), pl)
    np.testing.assert_array_equal(jconvert.bytes_be_to_planes(raw, d), pl)
    # a (D, 2, B) batch of planes is read lane by lane, flattened
    pl3 = np.stack([pl, pl[:, ::-1]], axis=1)
    assert tconvert.planes_to_bytes_be(pl3) == jconvert.planes_to_bytes_be(pl3)
    if d % 4 == 0:
        limbs = np.array([[(v >> (64 * j)) & ((1 << 64) - 1) for j in range(d // 4)]
                          for v in vals], dtype=np.uint64)
        np.testing.assert_array_equal(tconvert.u64le_to_planes(limbs), pl)
        np.testing.assert_array_equal(jconvert.u64le_to_planes(limbs), pl)


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


@pytest.mark.parametrize("fs", [jspecs.SECP256K1_FIELD, jspecs.P256_FIELD, MONT64, GLV32, TS64],
                         ids=lambda f: f.name)
def test_field_oracle_equals_the_reference(fs):
    """oracle/field.py's copy: every function on edge and random values,
    and the sqrt of every kind (p = 3 mod 4, 5 mod 8, Tonelli-Shanks)."""
    tfs = port_spec(fs)
    p = fs.p
    vals = rand_ints(np.random.default_rng(81), p, 12, edges=[0, 1, 2, p - 1, 4, 9])
    for a, b in zip(vals, vals[::-1]):
        for name in ("mont_mul", "mont_add", "mont_sub"):
            assert getattr(tfield, name)(a, b, tfs) == getattr(jfield, name)(a, b, fs), name
        for name in ("mont_from_classical", "mont_to_classical", "mont_sqr", "mont_opposite",
                     "mont_inverse", "mont_sqrt"):
            assert getattr(tfield, name)(a, tfs) == getattr(jfield, name)(a, fs), name
        assert tfield.mont_pow(a, b, tfs) == jfield.mont_pow(a, b, fs)
        assert tfield.mont_reduce(a * b, tfs) == jfield.mont_reduce(a * b, fs)


@pytest.mark.parametrize("curve", [jspecs.SECP256K1, TOYGLV], ids=lambda c: c.name)
def test_glv_params_and_order_field_equal_the_reference(curve):
    t, j = tglv.glv_params(port_spec(curve)), jglv.glv_params(curve)
    assert type(t) is tglv.GLVParams and type(j) is jglv.GLVParams
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert [f.name for f in dataclasses.fields(tglv.GLVParams)] == [
        f.name for f in dataclasses.fields(jglv.GLVParams)]
    _field_equal(tecdsa.order_field(port_spec(curve)), jecdsa.order_field(curve))
