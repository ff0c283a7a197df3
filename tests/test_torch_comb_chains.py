"""The port's multi-chain and unrolled comb (``comb_chains_plain``, the
plain version of kernel L) and the pipelined chain's plain version
(``comb_plain``, kernel K's), against the Python-int oracle's composition of
the same chains and against oracle scalar multiplication; with one chain,
every ``unroll`` (strict too) equals ``comb_plain``. The JAX interpret-mode
kernels (pipe, unroll = 2, chains = 2) are held to the port in ``slow``
tests, left out of tier-1 as the JAX package's own chains test is.
Tolerance: exact (0) — Jacobian planes bit for bit."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecsimd_tpu.kernels import comb as jcomb
from ecsimd_tpu.oracle import coz as ocoz
from ecsimd_tpu.specs import P256
from ecsimd_tpu_torch.kernels import comb as tcomb
from ecsimd_tpu_torch.oracle import comb as tocomb
from tests.toy import TOY64, TOY64E
from tests.torch_helpers import affine_ints, ints, oracle_comb_chains, planes, port_spec, rand_ints, tplanes

CPU = torch.device("cpu")


def _scalars(curve, seed, n, edges=(1, 2, 5)):
    rng = np.random.default_rng(seed)
    return [k + 1 for k in rand_ints(rng, curve.order - 2, n, edges=[e - 1 for e in edges])]


def _lanes(out):
    return list(zip(*(ints(t) for t in out)))


@pytest.mark.parametrize("unroll", [1, 2])
@pytest.mark.parametrize("chains", [2, 4])
@pytest.mark.parametrize("curve", [TOY64, P256], ids=lambda c: c.name)
def test_comb_chains_vs_oracle(curve, chains, unroll):
    """scalar_mult_base(chains, unroll) on CPU tensors (comb_chains_plain)
    against the oracle's composition of the same chains (exact Jacobian
    triples) and against oracle scalar multiplication (affine). TOY64 has 8
    positions, so chains = 4 with unroll = 2 takes one step a chain."""
    ks = _scalars(curve, 70 + chains, 6, edges=(1, 2, 5, curve.order - 2))
    tc = port_spec(curve)
    out = tcomb.scalar_mult_base(tplanes(ks, curve.field.ndigits), tc, chains=chains,
                                 unroll=unroll)
    tables, negbase = tcomb.base_tables(tc, curve.gx, curve.gy)
    got = _lanes([out.x.planes, out.y.planes, out.z.planes])
    assert got == [oracle_comb_chains(k, tables, negbase, curve, chains) for k in ks]
    assert affine_ints(got, curve.p) == [
        ocoz.scalar_mult_affine(k, curve.gx, curve.gy, curve) for k in ks]


@pytest.mark.parametrize("chains", [1, 2, 4])
@pytest.mark.parametrize("curve", [TOY64, P256], ids=lambda c: c.name)
def test_port_oracle_chains_match_jax_oracle(curve, chains):
    """The port's own composition of the chains (oracle.comb.chains, which
    chip_smoke.py uses to find degenerate lanes; one chain is the serial
    comb) against the same chains composed from the JAX package's oracle:
    exact Jacobian triples."""
    ks = _scalars(curve, 77 + chains, 6, edges=(1, 2, 5, curve.order - 2))
    tc = port_spec(curve)
    tables, negbase = tcomb.base_tables(tc, curve.gx, curve.gy)
    assert [tocomb.chains(k, tables, negbase, tc, chains) for k in ks] == [
        oracle_comb_chains(k, tables, negbase, curve, chains) for k in ks]


def test_port_oracle_add_raises_where_degenerate():
    """oracle.comb.add_z2_1 raises ZeroDivisionError on equal and on
    opposite x, also with z != 1, and equals the JAX oracle's add_z2_1
    elsewhere: exact."""
    tc, p = port_spec(P256), P256.p
    z = 0x1234567
    g = (P256.gx * z * z % p, P256.gy * z * z * z % p, z)  # G with z != 1
    for pt in ((P256.gx, P256.gy, 1), (P256.gx, p - P256.gy, 1)):
        with pytest.raises(ZeroDivisionError):
            tocomb.add_z2_1(g, pt, tc)
    q = (*ocoz.scalar_mult_affine(3, P256.gx, P256.gy, P256), 1)
    assert tocomb.add_z2_1(g, q, tc) == ocoz.add_z2_1(g, q, P256)


@functools.cache
def _one_chain_case(strict):
    """TOY64E scalars (k = n - 1 first: the strict chain completes it) and
    comb_plain's planes of them."""
    ks = [TOY64E.order - 1] + _scalars(TOY64E, 74, 5)
    tc = port_spec(TOY64E)
    s = tplanes(ks, TOY64E.field.ndigits)
    tables, negbase, _ = tcomb.device_tables(tc, TOY64E.gx, TOY64E.gy, CPU)
    return s, tcomb.comb_plain(s, tables, tc, negbase, strict)


@pytest.mark.parametrize("strict", [False, True], ids=["plain", "strict"])
@pytest.mark.parametrize("unroll", [1, 2, 4, 8])
def test_one_chain_is_comb_plain(unroll, strict):
    """With one chain, unroll changes no value: the entry point (through
    comb_chains_plain) equals comb_plain, strict included."""
    s, want = _one_chain_case(strict)
    out = tcomb.scalar_mult_base(s, port_spec(TOY64E), strict=strict, unroll=unroll)
    for a, b in zip((out.x.planes, out.y.planes, out.z.planes), want):
        assert torch.equal(a, b)


def test_pipe_is_the_serial_chain():
    """chain="pipe" on CPU tensors is comb_plain (the pipe's value is the
    serial chain's), whatever valid chains and unroll it is given."""
    ks = _scalars(TOY64, 75, 6)
    tc = port_spec(TOY64)
    s = tplanes(ks, TOY64.field.ndigits)
    tables, negbase, _ = tcomb.device_tables(tc, TOY64.gx, TOY64.gy, CPU)
    want = tcomb.comb_plain(s, tables, tc, negbase)
    out = tcomb.scalar_mult_base(s, tc, chain="pipe", chains=2, unroll=2)
    for a, b in zip((out.x.planes, out.y.planes, out.z.planes), want):
        assert torch.equal(a, b)


def _jax_interpret(ks, **kw):
    d = TOY64.field.ndigits
    jtables, jnegbase = jcomb._device_tables(TOY64, TOY64.gx, TOY64.gy)
    return jcomb.comb_mont_planes.__wrapped__(
        jnp.asarray(planes(ks, d)), jtables, TOY64, tuple(jnegbase), tile=128, interpret=True,
        **kw)


@pytest.mark.slow
@pytest.mark.parametrize("kw", [{"chain": "pipe"}, {"unroll": 2}, {"chains": 2}],
                         ids=lambda kw: "-".join(f"{k}{v}" for k, v in kw.items()))
def test_schedule_matches_jax_interpret_toy64(kw):
    """The JAX serial kernel with unroll = 2 or chains = 2, and the pipe
    kernel, in interpret mode (128 lanes, one tile) against the port's
    entry point on CPU tensors: exact Jacobian planes. chains = 2 takes
    more than ten minutes of XLA:CPU eager dispatch."""
    ks = _scalars(TOY64, 76, 128)
    out = tcomb.scalar_mult_base(tplanes(ks, TOY64.field.ndigits), port_spec(TOY64), **kw)
    want = _jax_interpret(ks, **kw)
    for t, j in zip((out.x.planes, out.y.planes, out.z.planes), want):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
