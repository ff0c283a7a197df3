"""The port's comb tree (``comb_tree_plain``, the plain version of kernel J)
and the affine + affine add under it (``group.aff_add``), against the JAX
package (``coz.aff_add_fused``, ``comb.comb_tree_host_planes``, run eagerly
as its own tests run them) and against the Python-int oracle's composition
of the same tree. Tolerance: exact (0) — Jacobian planes bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecsimd_tpu.kernels import comb as jcomb
from ecsimd_tpu.kernels.coz import aff_add_fused
from ecsimd_tpu.kernels.digits import VGFp
from ecsimd_tpu.oracle import coz as ocoz
from ecsimd_tpu.oracle import window as ow
from ecsimd_tpu.specs import P256, P384
from ecsimd_tpu_torch.curves import group
from ecsimd_tpu_torch.field import GFp
from ecsimd_tpu_torch.kernels import comb as tcomb
from ecsimd_tpu_torch.oracle import comb as tocomb
from tests.toy import TOY64
from tests.torch_helpers import affine_ints, ints, oracle_comb_tree, planes, port_spec, rand_ints, tplanes

CPU = torch.device("cpu")


def _scalars(curve, seed, n, edges=(1, 2, 5)):
    rng = np.random.default_rng(seed)
    return [k + 1 for k in rand_ints(rng, curve.order - 2, n, edges=[e - 1 for e in edges])]


def _lanes(out):
    return list(zip(*(ints(t) for t in out)))


@pytest.mark.parametrize("curve", [TOY64, P256], ids=lambda c: c.name)
def test_aff_add_matches_jax_and_oracle(curve):
    """group.aff_add against the JAX aff_add_fused (eager, on digit planes)
    and the oracle's general add with z1 = z2 = 1: exact."""
    d = curve.field.ndigits
    rng = np.random.default_rng(60)
    ks = [k + 2 for k in rand_ints(rng, curve.order - 3, 8)]
    pts = [ocoz.scalar_mult_affine(k, curve.gx, curve.gy, curve) for k in ks]
    p1, p2 = pts[:4], pts[4:]
    cols = [[p[i] for p in ps] for ps in (p1, p2) for i in (0, 1)]  # x1, y1, x2, y2
    fs = port_spec(curve.field)
    got = group.aff_add(*(GFp(tplanes(c, d), fs) for c in cols))
    got = _lanes([t.planes for t in got])
    jx = [jnp.asarray(planes(c, d)) for c in cols]
    want = aff_add_fused(*(VGFp([a[k] for k in range(d)], curve.field) for a in jx))
    want = _lanes([np.asarray(jnp.stack(v.digs)) for v in want])
    assert got == want
    assert got == [ow._jac_add((*a, 1), (*b, 1), curve) for a, b in zip(p1, p2)]


def test_comb_tree_plain_matches_jax_toy64():
    """comb_tree_plain against the JAX eager tree twin on TOY64 (8
    positions: level 1 of 4 affine adds, then 2 levels), 16 lanes, edge
    scalars 1, 2, 5 first: exact Jacobian planes."""
    ks = _scalars(TOY64, 61, 16)
    d = TOY64.field.ndigits
    tt = port_spec(TOY64)
    tables, negbase, _ = tcomb.device_tables(tt, TOY64.gx, TOY64.gy, CPU)
    got = tcomb.comb_tree_plain(tplanes(ks, d), tables, tt, negbase)
    jtables, jnegbase = jcomb._device_tables(TOY64, TOY64.gx, TOY64.gy)
    want = jcomb.comb_tree_host_planes(jnp.asarray(planes(ks, d)), jtables, TOY64,
                                       tuple(jnegbase))
    for t, j in zip(got, want):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("curve", [TOY64, P256, P384], ids=lambda c: c.name)
def test_comb_tree_vs_oracle(curve):
    """scalar_mult_base(chain="tree") on CPU tensors (comb_tree_plain)
    against the oracle's composition of the same tree (exact Jacobian
    triples) and against oracle scalar multiplication (affine). P-384's 48
    positions leave an odd level (3 nodes): the last node passes on."""
    ks = _scalars(curve, 62, 8, edges=(1, 2, 5, curve.order - 2))
    tc = port_spec(curve)
    s = tplanes(ks, curve.field.ndigits)
    out = tcomb.scalar_mult_base(s, tc, chain="tree")
    tables, negbase = tcomb.base_tables(tc, curve.gx, curve.gy)
    got = _lanes([out.x.planes, out.y.planes, out.z.planes])
    assert got == [oracle_comb_tree(k, tables, negbase, curve) for k in ks]
    assert affine_ints(got, curve.p) == [
        ocoz.scalar_mult_affine(k, curve.gx, curve.gy, curve) for k in ks]


@pytest.mark.parametrize("curve", [TOY64, P256], ids=lambda c: c.name)
def test_port_oracle_tree_matches_jax_oracle(curve):
    """The port's own composition of the tree (oracle.comb.tree, which
    chip_smoke.py uses to find degenerate lanes) against the same tree
    composed from the JAX package's oracle: exact Jacobian triples."""
    ks = _scalars(curve, 63, 8, edges=(1, 2, 5, curve.order - 2))
    tc = port_spec(curve)
    tables, negbase = tcomb.base_tables(tc, curve.gx, curve.gy)
    assert [tocomb.tree(k, tables, negbase, tc) for k in ks] == [
        oracle_comb_tree(k, tables, negbase, curve) for k in ks]


def test_tables_from_jax_f32_and_int8_tables():
    """tables_from_numpy takes the JAX package's f32 digit tables (what its
    tree and pipe read) and its int8 biased half-digit tables, and gives
    back the int32 digits."""
    own, _, _ = tcomb.device_tables(port_spec(P256), P256.gx, P256.gy, CPU)
    f32, _ = jcomb._device_tables(P256, P256.gx, P256.gy)
    i8, _ = jcomb._device_tables8(P256, P256.gx, P256.gy)
    assert f32.dtype == jnp.float32 and i8.dtype == jnp.int8 and i8.shape[2] == 64
    for t in (f32, i8):
        assert torch.equal(tcomb.tables_from_numpy(t, CPU), own)
    with pytest.raises(ValueError, match="16-bit digits"):
        tcomb.tables_from_numpy(np.asarray(f32) + 0.5, CPU)
