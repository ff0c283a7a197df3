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
from ecsimd_tpu.ops import bignum as jbn
from ecsimd_tpu.ops import solinas as jsolinas
from ecsimd_tpu.specs import P256_FIELD, P384_FIELD, P521_FIELD, SECP256K1_FIELD, W25519_FIELD
from ecsimd_tpu_torch import field as tfield
from ecsimd_tpu_torch.ops import bignum as tbn
from ecsimd_tpu_torch.ops import solinas as tsolinas
from tests.toy import CRAN64, GOLDILOCKS, MONT64
from tests.torch_helpers import ints, planes, port_spec, rand_ints, tplanes

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
    tfs = port_spec(fs)
    assert tsolinas.reduction_matrix(tfs) == jsolinas.reduction_matrix(fs)
    assert tsolinas._cbar_digit_terms(tfs) == jsolinas._cbar_digit_terms(fs)
    d = fs.ndigits
    for ncols, bound, lo in [(2 * d + 1, 1 << 22, 0), (2 * d + 1, 4 << 22, 0),
                             (2 * d + 1, 3 << 22, -(2 << 22))]:
        assert tsolinas._plan(tfs, ncols, bound, lo) == jsolinas._plan(fs, ncols, bound, lo)
    cbar = (1 << fs.nbits) % fs.p
    assert tsolinas._balanced_words(cbar, fs.nbits // 32) == jsolinas._balanced_words(
        cbar, fs.nbits // 32)


@pytest.mark.parametrize("fs", FIELDS, ids=lambda f: f.name)
def test_gfp_ops_match_jax_and_oracle(fs):
    a, b = _operands(fs, 1)
    p, d = fs.p, fs.ndigits
    tfs = port_spec(fs)
    ta, tb = tfield.GFp(tplanes(a, d), tfs), tfield.GFp(tplanes(b, d), tfs)
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
    tfs = port_spec(fs)
    ta, tb = tfield.GFp(tplanes(a, d), tfs), tfield.GFp(tplanes(b, d), tfs)
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
    tfs = port_spec(fs)
    x = tfield.GFp(tplanes(a, d), tfs)
    assert ints(x.inverse().planes) == want
    assert ints(x.batch_inverse().planes) == want
    # a batch that is not a power of two, and a single lane
    assert ints(tfield.GFp(tplanes(a[:5], d), tfs).batch_inverse().planes) == want[:5]
    assert ints(tfield.GFp(tplanes(a[2:3], d), tfs).batch_inverse().planes) == want[2:3]


def test_select_swap_and_constants():
    fs = port_spec(P256_FIELD)
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
    assert x.eq(x).tolist() == [1] * N and x.eq(y).tolist() == [int(u == v) for u, v in zip(a, b)]
    assert x.is_zero().tolist() == [int(u == 0) for u in a]


def test_compares_match_jax_bignum():
    """cmp_lt / cmp_eq / is_zero, the digit-plane compares ECDH's range
    checks use, against ops/bignum.py on equal, adjacent and random values."""
    p = P256_FIELD.p
    a, b = _operands(P256_FIELD, 5)
    a, b = a + [p, p - 1, 7, 0], b + [p, p, 6, 0]
    ta, tb = tplanes(a, 16).to(torch.int64), tplanes(b, 16).to(torch.int64)
    ja, jb = jnp.asarray(planes(a, 16)), jnp.asarray(planes(b, 16))
    for tfn, jfn in ((tbn.cmp_lt, jbn.cmp_lt), (tbn.cmp_eq, jbn.cmp_eq)):
        assert tfn(ta, tb).tolist() == np.asarray(jfn(ja, jb)).tolist()
    assert tbn.cmp_lt(ta, tb).tolist() == [int(u < v) for u, v in zip(a, b)]
    assert tbn.is_zero(ta).tolist() == np.asarray(jbn.is_zero(ja)).tolist()


@pytest.mark.parametrize("fs", [SECP256K1_FIELD, W25519_FIELD, P521_FIELD], ids=lambda f: f.name)
def test_unported_reductions_raise(fs):
    """No reduction is left unported: the Crandall fields (2^255 - 19 and
    P-521, ops/crandall.py, tests/test_torch_crandall.py) and the
    Montgomery field of secp256k1 (tests/test_torch_mont.py) all build
    GFp values, and a product round-trips through the classical domain."""
    x = tfield.GFp.from_classical(tplanes([1, 2], fs.ndigits), port_spec(fs))
    assert ints(x.to_classical()) == [1, 2]
    assert ints((x * x).to_classical()) == [1, 4]


@pytest.mark.parametrize("fs", [GOLDILOCKS, MONT64, CRAN64], ids=lambda f: f.name)
def test_from_mont_zero_and_pow_planes_match_jax(fs):
    """GFp.from_mont (internal-form planes kept as they are), GFp.zero and
    pow_planes (a per-lane exponent over every D 16 bits) against the JAX
    package's methods on a Solinas, a Montgomery and a Crandall field."""
    rng = np.random.default_rng(170)
    d, tfs = fs.ndigits, port_spec(fs)
    a = rand_ints(rng, fs.p, 6, edges=[0, 1, fs.p - 1])
    e = rand_ints(rng, 1 << (16 * d), 6, edges=[0, (1 << (16 * d)) - 1, fs.p - 2])
    ja = jfield.GFp.from_classical(jnp.asarray(planes(a, d)), fs)
    ta = tfield.GFp.from_classical(tplanes(a, d), tfs)
    np.testing.assert_array_equal(tfield.GFp.from_mont(ta.planes, tfs).planes.numpy(),
                                  np.asarray(jfield.GFp.from_mont(ja.planes, fs).planes))
    np.testing.assert_array_equal(tfield.GFp.zero(tfs, ta.planes).planes.numpy(),
                                  np.asarray(jfield.GFp.zero(fs, ja.planes).planes))
    got = ta.pow_planes(tplanes(e, d))
    np.testing.assert_array_equal(got.planes.numpy(),
                                  np.asarray(ja.pow_planes(jnp.asarray(planes(e, d))).planes))
    assert ints(got.to_classical()) == [pow(x, k, fs.p) for x, k in zip(a, e)]
