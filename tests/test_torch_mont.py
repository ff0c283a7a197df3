"""The port's CIOS Montgomery arithmetic (ecsimd_tpu_torch/ops/mont.py and
field.GFp over Montgomery fields) against the JAX package's ops/mont.py and
the Python-int Montgomery oracle (oracle/field.py), on the toy fields MONT64
and GLV32, the secp256k1 base field and the P-256 and secp256k1 order
fields. Tolerance: exact (Montgomery-form planes identical, R = 2^nbits on
both sides). The JAX package's eager ops compile for seconds per 256-bit
field on the CPU, and its powers and batch inverse per field and exponent:
the single operations are held to JAX on the toy fields (the same code at
2 and 4 digits), the 256-bit fields to the oracle, and the powers to JAX on
one toy field. Since every result is canonical on both sides, equal oracle
values mean equal planes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecsimd_tpu import ecdsa as jecdsa
from ecsimd_tpu.field import GFp as JGFp
from ecsimd_tpu.ops import mont as jmont
from ecsimd_tpu.oracle import field as ofield
from ecsimd_tpu.specs import P256, SECP256K1, SECP256K1_FIELD
from ecsimd_tpu_torch import field as tfield
from ecsimd_tpu_torch.ops import bignum as tbn
from ecsimd_tpu_torch.ops import mont as tmont
from tests.toy import GLV32, MONT64, TS64
from tests.torch_helpers import ints, planes, port_spec, rand_ints, tplanes

FIELDS = [MONT64, GLV32, SECP256K1_FIELD, jecdsa.order_field(P256),
          jecdsa.order_field(SECP256K1)]
IDS = [f.name for f in FIELDS]
WITH_JAX = (MONT64, GLV32)
N = 10


def _operands(fs, seed):
    rng = np.random.default_rng(seed)
    p = fs.p
    a = rand_ints(rng, p, N, edges=[0, 1, p - 1, p - 2])
    b = rand_ints(rng, p, N, edges=[p - 1, 0, p - 2, 1])
    return a, b


def _wide(vals, d):
    return tplanes(vals, d).to(torch.int64)


@pytest.mark.parametrize("fs", FIELDS, ids=IDS)
def test_cios_ops_match_jax_and_oracle(fs):
    """mont_mul, mont_sqr, from/to classical, mont_one and mont_reduce:
    values equal to the oracle's, planes equal to ops/mont.py's (WITH_JAX)."""
    a, b = _operands(fs, 110)
    d, p = fs.ndigits, fs.p
    tfs = port_spec(fs)
    ta, tb = _wide(a, d), _wide(b, d)
    t = [x * y for x, y in zip(a, b)]  # mont_reduce's input: a 2D-digit t < R p
    got = [tmont.mont_mul(ta, tb, tfs), tmont.mont_sqr(ta, tfs),
           tmont.mont_from_classical(ta, tfs), tmont.mont_to_classical(ta, tfs),
           tmont.mont_one(tfs, ta), tmont.mont_reduce(_wide(t, 2 * d), tfs)]
    want = [[ofield.mont_mul(x, y, fs) for x, y in zip(a, b)],
            [ofield.mont_sqr(x, fs) for x in a],
            [ofield.mont_from_classical(x, fs) for x in a],
            [ofield.mont_to_classical(x, fs) for x in a],
            [fs.R_mod_p] * N,
            [ofield.mont_reduce(v, fs) for v in t]]
    for g, w in zip(got, want):
        assert g.dtype == torch.int64
        assert ints(g) == w and all(v < p for v in ints(g))
    if fs in WITH_JAX:
        ja, jb = jnp.asarray(planes(a, d)), jnp.asarray(planes(b, d))
        jwant = [jmont.mont_mul(ja, jb, fs), jmont.mont_sqr(ja, fs),
                 jmont.mont_from_classical(ja, fs), jmont.mont_to_classical(ja, fs),
                 jmont.mont_one(fs, ja), jmont.mont_reduce(jnp.asarray(planes(t, 2 * d)), fs)]
        for g, w in zip(got, jwant):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("fs", FIELDS, ids=IDS)
def test_gfp_montgomery_field_matches_oracle(fs):
    """GFp over a Montgomery field: the arithmetic, pow_const, inverse and
    batch_inverse (zero lanes give 0), against the oracle. A 256-bit Fermat
    chain costs ~1 s here, so the 256-bit fields run one (the batch root)."""
    a, b = _operands(fs, 111)
    d, p = fs.ndigits, fs.p
    tfs = port_spec(fs)
    x, y = tfield.GFp(tplanes(a, d), tfs), tfield.GFp(tplanes(b, d), tfs)
    assert ints((x * y).planes) == [ofield.mont_mul(u, v, fs) for u, v in zip(a, b)]
    assert ints((x + y).planes) == [ofield.mont_add(u, v, fs) for u, v in zip(a, b)]
    assert ints((x - y).planes) == [ofield.mont_sub(u, v, fs) for u, v in zip(a, b)]
    assert ints(x.opposite().planes) == [ofield.mont_opposite(u, fs) for u in a]
    assert ints(x.mul_scaled(y, 4).planes) == [4 * ofield.mont_mul(u, v, fs) % p
                                               for u, v in zip(a, b)]
    assert ints(x.pow_const(5).planes) == [ofield.mont_pow(u, 5, fs) for u in a]
    inv = [ofield.mont_inverse(u, fs) for u in a]
    assert ints(x.batch_inverse().planes) == inv
    if d <= 4:
        assert ints(x.inverse().planes) == inv
        assert ints(tfield.GFp(tplanes(a[:5], d), tfs).batch_inverse().planes) == inv[:5]
    # classical round trip and constants
    c = tfield.GFp.from_classical(tplanes(a, d), tfs)
    assert ints(c.planes) == [ofield.mont_from_classical(u, fs) for u in a]
    assert ints(c.to_classical()) == a
    assert ints(x.const_like(7).planes) == [ofield.mont_from_classical(7, fs)] * N
    assert ints(tfield.GFp.one(tfs, x.planes).planes) == [fs.R_mod_p] * N


def test_pow_matches_jax_on_glv32():
    """pow_const, inverse and batch_inverse against the JAX GFp on the
    2-digit toy field (its compiles are short there)."""
    fs = GLV32
    a, _ = _operands(fs, 112)
    x = tfield.GFp(tplanes(a, 2), port_spec(fs))
    jx = JGFp(jnp.asarray(planes(a, 2)), fs)
    for got, want in ((x.pow_const(5), jx.pow_const(5)), (x.inverse(), jx.inverse()),
                      (x.batch_inverse(), jx.batch_inverse())):
        np.testing.assert_array_equal(got.planes.numpy(), np.asarray(want.planes))


@pytest.mark.parametrize("fs", [GLV32, SECP256K1_FIELD], ids=lambda f: f.name)
def test_pow_planes_per_lane_exponent(fs):
    a, b = _operands(fs, 113)
    d = fs.ndigits
    got = tmont.mont_pow_planes(_wide(a, d), _wide(b, d), port_spec(fs))
    assert ints(got) == [ofield.mont_pow(u, e, fs) for u, e in zip(a, b)]


@pytest.mark.parametrize("fs", [SECP256K1_FIELD, GLV32, TS64], ids=lambda f: f.name)
def test_sqrt_matches_oracle(fs):
    """The three square-root kinds (p = 3 mod 4 on secp256k1, p = 5 mod 8 on
    GLV32, Tonelli-Shanks on TS64): root and mask as oracle.field.mont_sqrt,
    squares and non-residues mixed, sqrt(0) = 0."""
    a, _ = _operands(fs, 114)
    p, d = fs.p, fs.ndigits
    vals = [ofield.mont_from_classical(u * u % p, fs) for u in a[:5]] + a[5:]
    r, ok = tfield.GFp(tplanes(vals, d), port_spec(fs)).sqrt()
    for v, root, good in zip(vals, ints(r.planes), ok.tolist()):
        want = ofield.mont_sqrt(v, fs)
        assert good == (want is not None)
        if want is not None:
            assert root == want
    assert ok.tolist()[:5] == [1] * 5


def test_bignum_helpers_match_jax():
    """mul, pad, sub_if_above, and the carry ripple of a redundant
    accumulator (normalize_signed against JAX's normalize), against
    ops/bignum.py."""
    from ecsimd_tpu.ops import bignum as jbn

    a, b = _operands(SECP256K1_FIELD, 115)
    ta, tb = _wide(a, 16), _wide(b, 16)
    ja, jb = jnp.asarray(planes(a, 16)), jnp.asarray(planes(b, 16))
    np.testing.assert_array_equal(tbn.mul(ta, tb).numpy(), np.asarray(jbn.mul(ja, jb)))
    assert ints(tbn.mul(ta, tb)) == [u * v for u, v in zip(a, b)]
    np.testing.assert_array_equal(tbn.pad(ta, 20).numpy(), np.asarray(jbn.pad(ja, 20)))
    np.testing.assert_array_equal(tbn.sub_if_above(ta, tb).numpy(),
                                  np.asarray(jbn.sub_if_above(ja, jb)))
    acc = ta * 3 + tb  # redundant digits
    got, carry = tbn.normalize_signed(acc)
    jgot, jcarry = jbn.normalize(jnp.asarray(acc.numpy().astype(np.int32)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jgot))
    np.testing.assert_array_equal(carry.numpy(), np.asarray(jcarry))
