"""The port's Crandall fold (ecsimd_tpu_torch/ops/crandall.py) and GFp on
Crandall fields, against the JAX package's ops/crandall.py on the 4-digit
toy field CRAN64 (p = 2^61 - 1) and against Python ints on 2^255 - 19 and
P-521, edge values included. No JAX call runs on the 16- or 33-digit
fields (one eager JAX fold there costs seconds). Tolerance: exact."""

import jax.numpy as jnp
import numpy as np
import pytest

from ecsimd_tpu.ops import crandall as jcrandall
from ecsimd_tpu.specs import P521_FIELD, W25519_FIELD
from ecsimd_tpu_torch.field import GFp
from ecsimd_tpu_torch.ops import crandall as tcrandall
from tests.toy import CRAN64
from tests.torch_helpers import ints, planes, port_spec, rand_ints, tplanes

SCALES = (1, 2, 3, 4)


def _cases(fs, seed, n=12):
    """Edge values, some at or above p (the fold takes any input below
    2^nbits), then uniform ints below 2^nbits."""
    p, top = fs.p, 1 << fs.nbits
    edges = [0, 1, 2, p - 1, p - 2, p, p + 1, top - 1, top - 38, top - 39, (1 << 255) - 20]
    return rand_ints(np.random.default_rng(seed), top, n, edges=[e % top for e in edges])


def test_fast_mul_sqr_match_jax_cran64():
    fs = CRAN64
    a, b = _cases(fs, 50), _cases(fs, 51)[::-1]
    ta, tb = (tplanes(v, fs.ndigits).long() for v in (a, b))
    ja, jb = (jnp.asarray(planes(v, fs.ndigits)) for v in (a, b))
    tfs = port_spec(fs)
    for scale in SCALES:
        got = tcrandall.fast_mul(ta, tb, tfs, scale).numpy()
        np.testing.assert_array_equal(got, np.asarray(jcrandall.fast_mul(ja, jb, fs, scale)))
        got = tcrandall.fast_sqr(ta, tfs, scale).numpy()
        np.testing.assert_array_equal(got, np.asarray(jcrandall.fast_sqr(ja, fs, scale)))
        assert ints(got) == [scale * x * x % fs.p for x in a]


@pytest.mark.parametrize("fs", [W25519_FIELD, P521_FIELD], ids=lambda f: f.name)
def test_fast_mul_sqr_vs_ints(fs):
    a, b = _cases(fs, 52), _cases(fs, 53)[::-1]
    ta, tb = (tplanes(v, fs.ndigits).long() for v in (a, b))
    tfs = port_spec(fs)
    for scale in SCALES:
        assert ints(tcrandall.fast_mul(ta, tb, tfs, scale)) == [
            scale * x * y % fs.p for x, y in zip(a, b)]
        assert ints(tcrandall.fast_sqr(ta, tfs, scale)) == [scale * x * x % fs.p for x in a]


@pytest.mark.parametrize("fs", [CRAN64, W25519_FIELD, P521_FIELD], ids=lambda f: f.name)
def test_grid_col_bound_and_fold_plan(fs):
    """The column bound equals the JAX package's, and the port's own fold
    proof (no copy of the JAX _plan: the int64 planes need fewer steps)
    accepts it up to scale 8 with one bit fold."""
    tfs = port_spec(fs)
    for scale in (1, 8):
        bound = tcrandall.grid_col_bound(tfs, scale)
        assert bound == jcrandall.grid_col_bound(fs, scale)
        plan = tcrandall._fold_plan(tfs, 2 * fs.ndigits + 1, bound)
        assert plan.cc == (1 << fs.nbits) % fs.p and plan.c == (1 << fs.p.bit_length()) - fs.p
        assert plan.nbitfold == 1


def test_gfp_inverse_batch_inverse_and_sqrt_w25519():
    fs = port_spec(W25519_FIELD)
    p = fs.p
    vals = rand_ints(np.random.default_rng(54), p, 7, edges=[1, p - 1, 0, 2, 0])
    x = GFp(tplanes(vals, 16), fs)
    inv = [pow(v, p - 2, p) for v in vals]  # inverse(0) = 0
    assert ints(x.inverse().planes) == inv
    assert ints(x.batch_inverse().planes) == inv
    r, ok = (x * x).sqrt()  # p = 5 (mod 8): the Atkin shape with the sqrt(-1) fix-up
    assert ok.tolist() == [1] * len(vals)
    assert ints(r.sqr().planes) == [v * v % p for v in vals]
    r2, ok2 = x.const_like(2).sqrt()  # 2 is a non-residue mod p
    assert ok2.tolist() == [0] * len(vals) and r2.planes.shape == x.planes.shape
