"""The port's field layer (ecsimd_tpu_torch.field.GFp, ops/solinas) against
the JAX package's field.GFp, its kernel-side digit ops (kernels/digits.py,
called eagerly on digit lists as tests/test_kernels.py feeds them) and the
Python-int oracle. Tolerance: exact (canonical residues in [0, p))."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecsimd_tpu import field as jfield
from ecsimd_tpu.kernels import digits as jdigits
from ecsimd_tpu.ops import solinas as jsolinas
from ecsimd_tpu.specs import P256_FIELD, P384_FIELD, SECP256K1_FIELD, W25519_FIELD
from ecsimd_tpu_torch import field as tfield
from ecsimd_tpu_torch.ops import solinas as tsolinas
from tests.toy import GOLDILOCKS
from tests.torch_helpers import ints, planes, rand_ints, tplanes

FIELDS = [P256_FIELD, GOLDILOCKS]
N = 12


def _operands(fs, seed):
    rng = np.random.default_rng(seed)
    p = fs.p
    a = rand_ints(rng, p, N, edges=[0, 1, p - 1, p - 2])
    b = rand_ints(rng, p, N, edges=[p - 1, 0, p - 2, 1])
    return a, b


@pytest.mark.parametrize("fs", [P256_FIELD, P384_FIELD, GOLDILOCKS], ids=lambda f: f.name)
def test_planner_copies_equal_jax(fs):
    assert tsolinas.reduction_matrix(fs) == jsolinas.reduction_matrix(fs)
    assert tsolinas._cbar_digit_terms(fs) == jsolinas._cbar_digit_terms(fs)
    d = fs.ndigits
    for ncols, bound, lo in [(2 * d + 1, 1 << 22, 0), (2 * d + 1, 4 << 22, 0),
                             (2 * d + 1, 3 << 22, -(2 << 22))]:
        assert tsolinas._plan(fs, ncols, bound, lo) == jsolinas._plan(fs, ncols, bound, lo)
    cbar = (1 << fs.nbits) % fs.p
    assert tsolinas._balanced_words(cbar, fs.nbits // 32) == jsolinas._balanced_words(
        cbar, fs.nbits // 32)


@pytest.mark.parametrize("fs", FIELDS, ids=lambda f: f.name)
def test_gfp_ops_match_jax_and_oracle(fs):
    a, b = _operands(fs, 1)
    p, d = fs.p, fs.ndigits
    ta, tb = tfield.GFp(tplanes(a, d), fs), tfield.GFp(tplanes(b, d), fs)
    ja = jfield.GFp(jnp.asarray(planes(a, d)), fs)
    jb = jfield.GFp(jnp.asarray(planes(b, d)), fs)
    # (name, op, oracle values, also against JAX GFp). JAX's eager squarings
    # and pow_const compile for seconds each on the CPU; the squaring is
    # held against JAX through kernels/digits.field_sqr below instead.
    cases = [
        ("mul", lambda x, y: x * y, [u * v % p for u, v in zip(a, b)], True),
        ("sqr", lambda x, y: x.sqr(), [u * u % p for u in a], False),
        ("add", lambda x, y: x + y, [(u + v) % p for u, v in zip(a, b)], True),
        ("sub", lambda x, y: x - y, [(u - v) % p for u, v in zip(a, b)], True),
        ("double", lambda x, y: x.double(), [2 * u % p for u in a], True),
        ("opposite", lambda x, y: x.opposite(), [(-u) % p for u in a], True),
        ("mul_scaled4", lambda x, y: x.mul_scaled(y, 4), [4 * u * v % p for u, v in zip(a, b)],
         True),
        ("sqr_scaled2", lambda x, y: x.sqr_scaled(2), [2 * u * u % p for u in a], False),
        ("shift_left3", lambda x, y: x.shift_left(3), [8 * u % p for u in a], True),
        ("pow_const", lambda x, y: x.pow_const(5), [pow(u, 5, p) for u in a], False),
    ]
    for name, op, want, with_jax in cases:
        got = op(ta, tb)
        assert got.planes.dtype == torch.int32, name
        assert ints(got.planes) == want, name
        if with_jax:
            np.testing.assert_array_equal(
                got.planes.numpy(), np.asarray(op(ja, jb).planes), name)


@pytest.mark.parametrize("fs", FIELDS, ids=lambda f: f.name)
def test_gfp_matches_kernel_digit_ops(fs):
    """The JAX kernels' digit-list field layer, run eagerly on jnp rows."""
    a, b = _operands(fs, 2)
    d = fs.ndigits
    ta, tb = tfield.GFp(tplanes(a, d), fs), tfield.GFp(tplanes(b, d), fs)
    la = [jnp.asarray(r) for r in planes(a, d)]
    lb = [jnp.asarray(r) for r in planes(b, d)]
    cases = [
        (jdigits.field_mul(la, lb, fs), ta * tb),
        (jdigits.field_sqr(la, fs), ta.sqr()),
        (jdigits.mod_add(la, lb, fs), ta + tb),
        (jdigits.mod_sub(la, lb, fs), ta - tb),
        (jdigits.mod_opposite(la, fs), ta.opposite()),
        (jdigits.mod_double(la, fs), ta.double()),
    ]
    for want, got in cases:
        np.testing.assert_array_equal(got.planes.numpy(), np.stack([np.asarray(r) for r in want]))


@pytest.mark.parametrize("fs", FIELDS, ids=lambda f: f.name)
def test_inverse_and_batch_inverse(fs):
    a, _ = _operands(fs, 3)
    p, d = fs.p, fs.ndigits
    want = [pow(u, p - 2, p) for u in a]  # inverse(0) = 0
    x = tfield.GFp(tplanes(a, d), fs)
    assert ints(x.inverse().planes) == want
    assert ints(x.batch_inverse().planes) == want
    # a batch that is not a power of two, and a single lane
    assert ints(tfield.GFp(tplanes(a[:5], d), fs).batch_inverse().planes) == want[:5]
    assert ints(tfield.GFp(tplanes(a[2:3], d), fs).batch_inverse().planes) == want[2:3]


def test_select_swap_and_constants():
    fs = P256_FIELD
    a, b = _operands(fs, 4)
    d = fs.ndigits
    x, y = tfield.GFp(tplanes(a, d), fs), tfield.GFp(tplanes(b, d), fs)
    mask = torch.tensor([i % 2 for i in range(N)])
    want_x = [u if i % 2 else v for i, (u, v) in enumerate(zip(a, b))]
    assert ints(x.select(mask, y).planes) == want_x
    s, t = tfield.gfp_swap_if(mask, x, y)
    assert ints(s.planes) == [v if i % 2 else u for i, (u, v) in enumerate(zip(a, b))]
    assert ints(t.planes) == want_x
    assert ints(x.const_like(fs.p + 5).planes) == [5] * N
    assert ints(tfield.GFp.one(fs, x.planes).planes) == [1] * N


@pytest.mark.parametrize("fs", [SECP256K1_FIELD, W25519_FIELD], ids=lambda f: f.name)
def test_unported_reductions_raise(fs):
    with pytest.raises(NotImplementedError, match="ROADMAP A6"):
        tfield.GFp(tplanes([1], fs.ndigits), fs)
