"""The port's fixed-base comb — host tables, entry indices and comb_plain,
the plain version of kernel B, in both strict modes — against the JAX
package (kernels/comb.py) and the Python-int oracle. Tolerance: exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecsimd_tpu.kernels import comb as jcomb
from ecsimd_tpu.oracle import coz as ocoz
from ecsimd_tpu.specs import P256, SECP256K1
from ecsimd_tpu_torch import api
from ecsimd_tpu_torch.kernels import comb as tcomb
from tests.toy import TOY64, TOY64E
from tests.torch_helpers import ints, planes, port_spec, rand_ints, tplanes

N = 8
CPU = torch.device("cpu")
TP256, TTOY64, TTOY64E = port_spec(P256), port_spec(TOY64), port_spec(TOY64E)


def _scalars(curve, seed, edges=()):
    rng = np.random.default_rng(seed)
    return [k + 1 for k in rand_ints(rng, curve.order - 2, N, edges=[e - 1 for e in edges])]


@pytest.mark.parametrize("curve", [P256, TOY64], ids=lambda c: c.name)
def test_base_tables_and_entry_indices_equal_jax(curve):
    tables, negbase = tcomb.base_tables(port_spec(curve), curve.gx, curve.gy)
    jtables, jnegbase = jcomb.base_tables(curve, curve.gx, curve.gy)
    np.testing.assert_array_equal(tables, jtables)
    assert negbase == jnegbase
    ks = _scalars(curve, 20, edges=[1, 2, 5, curve.order - 2])
    d = curve.field.ndigits
    got = tcomb.entry_indices(tplanes(ks, d), port_spec(curve))
    want = jcomb.entry_indices(jnp.asarray(planes(ks, d)), curve)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _comb_plain_vs_jax_toy64(strict, seed):
    ks = _scalars(TOY64, seed, edges=[1, 2, 5])
    d = TOY64.field.ndigits
    tables, negbase, _ = tcomb.device_tables(TTOY64, TOY64.gx, TOY64.gy, CPU)
    got = tcomb.comb_plain(tplanes(ks, d), tables, TTOY64, negbase, strict)
    jtables, jnegbase = jcomb._device_tables(TOY64, TOY64.gx, TOY64.gy)
    want = jcomb.comb_xla_planes(jnp.asarray(planes(ks, d)), jtables, TOY64, tuple(jnegbase),
                                 strict=strict)
    for t, j in zip(got, want):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_comb_plain_matches_jax_toy64():
    _comb_plain_vs_jax_toy64(False, 21)


def test_strict_comb_plain_matches_jax_toy64():
    _comb_plain_vs_jax_toy64(True, 24)


def test_scalar_mult_base_p256_vs_oracle():
    ks = _scalars(P256, 22, edges=[1, 2, 5, P256.order - 2])
    out = api.scalar_mult_base(api.scalars_from_ints(ks, TP256, device="cpu"), TP256)
    assert list(zip(ints(out.x), ints(out.y))) == [
        ocoz.scalar_mult_affine(k, P256.gx, P256.gy, P256) for k in ks]


@pytest.mark.parametrize("curve", [TOY64E, P256], ids=lambda c: c.name)
def test_strict_comb_completes_order_minus_one(curve):
    """k = n - 1 (exact order): the chain lands on infinity and the strict
    fix-up resolves inf + (-G) = -G; the plain chain corrupts that lane.
    n - 2 and a few ordinary scalars ride along, against the oracle."""
    n, p = curve.order, curve.p
    ks = [n - 1, n - 2, 1, 2] + _scalars(curve, 25)[:2]
    s = api.scalars_from_ints(ks, port_spec(curve), device="cpu")
    out = api.scalar_mult_base(s, port_spec(curve), strict=True)
    want = [(curve.gx, (p - curve.gy) % p)] + [
        ocoz.scalar_mult_affine(k, curve.gx, curve.gy, curve) for k in ks[1:]]
    assert list(zip(ints(out.x), ints(out.y))) == want
    plain = api.scalar_mult_base(s[:, :1].contiguous(), port_spec(curve))
    assert (ints(plain.x)[0], ints(plain.y)[0]) != want[0]


def test_tables_from_jax_array_give_same_result():
    ks = _scalars(P256, 23, edges=[1, 2])
    d = P256.field.ndigits
    own, negbase, _ = tcomb.device_tables(TP256, P256.gx, P256.gy, CPU)
    jax_np = jcomb.base_tables(P256, P256.gx, P256.gy)[0]
    from_jax = tcomb.tables_from_numpy(jax_np, CPU)
    assert from_jax.dtype == torch.int32 and torch.equal(from_jax, own)
    s = tplanes(ks, d)
    for a, b in zip(tcomb.comb_plain(s, from_jax, TP256, negbase),
                    tcomb.comb_plain(s, own, TP256, negbase)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="int32"):
        tcomb.tables_from_numpy(jax_np.astype(np.int64), CPU)


@pytest.mark.parametrize("curve", [P256, SECP256K1], ids=lambda c: c.name)
def test_kernel_tables_hold_every_signed_entry(curve):
    """The kept entries as 32-bit limbs (comb.limb_layout, the rows that
    comb.mma_layout transposes into the kernels' u8 table), read the way the
    kernels read an entry: position 0 row e; position j >= 1 the row of
    magnitude m = (e & 127) ^ (127 if e < 128), y negated where e < 128.
    Every (position, entry) equals the digit tables' entry (internal form),
    and the negbase digits are -B's."""
    tc = port_spec(curve)
    tables, negbase = tcomb.base_tables(tc, curve.gx, curve.gy)
    limbs = tcomb.limb_layout(tables).view(np.uint32)
    assert limbs.shape == (256 + 31 * 128, 16)
    fs, p = curve.field, curve.p

    def limb_int(row):
        return sum(int(v) << (32 * i) for i, v in enumerate(row))

    def digit_int(row):
        return sum(int(v) << (16 * i) for i, v in enumerate(row))

    for j in range(32):
        for e in range(256):
            neg = j > 0 and e < 128
            row = limbs[e] if j == 0 else limbs[256 + (j - 1) * 128 + ((e & 127) ^ (127 * neg))]
            x, y = limb_int(row[:8]), limb_int(row[8:])
            assert (x, (p - y) % p if neg else y) == (digit_int(tables[j, e, :16]),
                                                        digit_int(tables[j, e, 16:]))
    _, _, nb = tcomb.device_tables(tc, curve.gx, curve.gy, CPU)
    assert [digit_int(nb[:16]), digit_int(nb[16:])] == [tcomb._to_internal(v, fs) for v in negbase]


@pytest.mark.parametrize("kw", [
    {"strict": True, "chain": "tree"}, {"strict": True, "chain": "pipe"},
    {"strict": True, "chains": 2}, {"chains": 3}, {"unroll": 3}, {"chains": 4, "unroll": 16},
    {"chain": "ladder"}, {"chains": 0},
], ids=lambda kw: "-".join(f"{k}{v}" for k, v in kw.items()))
def test_unported_options_raise(kw):
    """Every schedule the JAX package's comb_mont_planes rejects raises
    ValueError before any work: strict off the serial single chain, chains
    * unroll not dividing the 32 positions, an unknown chain."""
    s = api.scalars_from_ints([3], TP256, device="cpu")
    with pytest.raises(ValueError):
        tcomb.scalar_mult_base(s, TP256, **kw)


@pytest.mark.parametrize("entry", [tcomb.comb_tree_planes, tcomb.comb_pipe_planes,
                                   tcomb.comb_general_planes], ids=lambda f: f.__name__)
def test_schedule_kernel_entries_take_cuda_tensors_only(entry):
    tables, _, nb = tcomb.device_tables(TP256, P256.gx, P256.gy, CPU)
    with pytest.raises(ValueError, match="CUDA"):
        entry(api.scalars_from_ints([3], TP256, device="cpu"), tables, nb)


@pytest.mark.parametrize("strict", [False, True])
def test_kernel_entry_takes_cuda_tensors_only(strict):
    tables, _, nb = tcomb.device_tables(TP256, P256.gx, P256.gy, CPU)
    with pytest.raises(ValueError, match="CUDA"):
        tcomb.comb_planes(api.scalars_from_ints([3], TP256, device="cpu"), tables, nb,
                          strict=strict)
