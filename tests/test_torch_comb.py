"""The port's fixed-base comb — host tables, entry indices and comb_plain,
the plain version of kernel B — against the JAX package (kernels/comb.py)
and the Python-int oracle. Tolerance: exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecsimd_tpu.kernels import comb as jcomb
from ecsimd_tpu.oracle import coz as ocoz
from ecsimd_tpu.specs import P256
from ecsimd_tpu_torch import api
from ecsimd_tpu_torch.kernels import comb as tcomb
from tests.toy import TOY64
from tests.torch_helpers import ints, planes, rand_ints, tplanes

N = 8
CPU = torch.device("cpu")


def _scalars(curve, seed, edges=()):
    rng = np.random.default_rng(seed)
    return [k + 1 for k in rand_ints(rng, curve.order - 2, N, edges=[e - 1 for e in edges])]


@pytest.mark.parametrize("curve", [P256, TOY64], ids=lambda c: c.name)
def test_base_tables_and_entry_indices_equal_jax(curve):
    tables, negbase = tcomb.base_tables(curve, curve.gx, curve.gy)
    jtables, jnegbase = jcomb.base_tables(curve, curve.gx, curve.gy)
    np.testing.assert_array_equal(tables, jtables)
    assert negbase == jnegbase
    ks = _scalars(curve, 20, edges=[1, 2, 5, curve.order - 2])
    d = curve.field.ndigits
    got = tcomb.entry_indices(tplanes(ks, d), curve)
    want = jcomb.entry_indices(jnp.asarray(planes(ks, d)), curve)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_comb_plain_matches_jax_toy64():
    ks = _scalars(TOY64, 21, edges=[1, 2, 5])
    d = TOY64.field.ndigits
    tables, negbase, _ = tcomb.device_tables(TOY64, TOY64.gx, TOY64.gy, CPU)
    got = tcomb.comb_plain(tplanes(ks, d), tables, TOY64, negbase)
    jtables, jnegbase = jcomb._device_tables(TOY64, TOY64.gx, TOY64.gy)
    want = jcomb.comb_xla_planes(jnp.asarray(planes(ks, d)), jtables, TOY64, tuple(jnegbase))
    for t, j in zip(got, want):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_scalar_mult_base_p256_vs_oracle():
    ks = _scalars(P256, 22, edges=[1, 2, 5, P256.order - 2])
    out = api.scalar_mult_base(api.scalars_from_ints(ks, P256))
    assert list(zip(ints(out.x), ints(out.y))) == [
        ocoz.scalar_mult_affine(k, P256.gx, P256.gy, P256) for k in ks]


def test_tables_from_jax_array_give_same_result():
    ks = _scalars(P256, 23, edges=[1, 2])
    d = P256.field.ndigits
    own, negbase, _ = tcomb.device_tables(P256, P256.gx, P256.gy, CPU)
    jax_np = jcomb.base_tables(P256, P256.gx, P256.gy)[0]
    from_jax = tcomb.tables_from_numpy(jax_np, CPU)
    assert from_jax.dtype == torch.int32 and torch.equal(from_jax, own)
    s = tplanes(ks, d)
    for a, b in zip(tcomb.comb_plain(s, from_jax, P256, negbase),
                    tcomb.comb_plain(s, own, P256, negbase)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="int32"):
        tcomb.tables_from_numpy(jax_np.astype(np.int64), CPU)


@pytest.mark.parametrize("kw", [{"strict": True}, {"chains": 2}, {"unroll": 2}],
                         ids=lambda kw: next(iter(kw)))
def test_unported_options_raise(kw):
    s = api.scalars_from_ints([3], P256)
    with pytest.raises(NotImplementedError, match="ROADMAP B2"):
        tcomb.scalar_mult_base(s, P256, **kw)


def test_kernel_entry_takes_cuda_tensors_only():
    tables, _, nb = tcomb.device_tables(P256, P256.gx, P256.gy, CPU)
    with pytest.raises(ValueError, match="CUDA"):
        tcomb.comb_planes(api.scalars_from_ints([3], P256), tables, nb)
