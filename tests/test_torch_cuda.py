"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU with nvcc; elsewhere they skip. The file
imports no JAX and no other test module, so it also runs on a machine
without JAX (tests/conftest.py imports it, hence --noconftest):

    python -m pytest tests/test_torch_cuda.py -q --noconftest -p no:cacheprovider
"""

import numpy as np
import pytest
import torch

from ecsimd_tpu import convert
from ecsimd_tpu.oracle import coz
from ecsimd_tpu.oracle import window as ow
from ecsimd_tpu.specs import P256
from ecsimd_tpu_torch import api
from ecsimd_tpu_torch.curves import group
from ecsimd_tpu_torch.curves.point import AffinePoint, JacobianPoint
from ecsimd_tpu_torch.field import GFp
from ecsimd_tpu_torch.kernels import affine, comb, field_ops, ladder

pytestmark = pytest.mark.cuda
D = P256.field.ndigits


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def ints(t):
    return convert.planes_to_ints(t.cpu().numpy())


def rand_ints(rng, bound, n, edges=()):
    vals = list(edges) + [int.from_bytes(rng.bytes(40), "little") % bound for _ in range(n)]
    return vals[:n]


def multiples(curve, n):
    """Affine (i+1)*G for i < n."""
    p = curve.p
    jacs = [(curve.gx, curve.gy, 1), ow._jac_dbl((curve.gx, curve.gy, 1), curve)]
    while len(jacs) < n:
        jacs.append(ow._jac_add(jacs[-1], jacs[0], curve))
    return [(x * pow(z, -2, p) % p, y * pow(z, -3, p) % p) for x, y, z in jacs[:n]]


def _planes(vals, dev):
    return torch.from_numpy(convert.ints_to_planes(vals, D)).to(dev)


def _scalars(n, seed, dev):
    edges = [1, 2, 5, P256.order - 2]
    ks = [k + 1 for k in rand_ints(np.random.default_rng(seed), P256.order - 2, n,
                                   edges=[e - 1 for e in edges])]
    return ks, _planes(ks, dev)


def test_field_probe_kernel_matches_plain(cuda):
    p = P256.p
    rng = np.random.default_rng(40)
    a = rand_ints(rng, p, 4096, edges=[0, 1, p - 1, p - 2])
    b = rand_ints(rng, p, 4096, edges=[p - 1, p - 2, 0, 1])
    ta, tb = _planes(a, cuda), _planes(b, cuda)
    before = field_ops.KERNEL.launches
    got = field_ops.probe(ta, tb)
    assert field_ops.KERNEL.launches == before + 1
    assert torch.equal(got, field_ops.probe_plain(ta, tb))
    assert ints(got[0, :, :64]) == [x * y % p for x, y in zip(a[:64], b[:64])]


def test_comb_kernel_matches_plain_and_oracle(cuda):
    ks, s = _scalars(1024, 41, cuda)
    tables, negbase, nb = comb.device_tables(P256, P256.gx, P256.gy, cuda)
    before = comb.KERNEL.launches
    got = comb.comb_planes(s, tables, nb)
    assert comb.KERNEL.launches == before + 1
    for k, w in zip(got, comb.comb_plain(s, tables, P256, negbase)):
        assert torch.equal(k, w)
    out = api.scalar_mult_base(s[:, :16].contiguous())
    assert list(zip(ints(out.x), ints(out.y))) == [
        coz.scalar_mult_affine(k, P256.gx, P256.gy, P256) for k in ks[:16]]


def test_ladder_kernel_matches_plain_and_oracle(cuda):
    ks, s = _scalars(256, 42, cuda)
    pts = multiples(P256, 256)
    xs, ys = _planes([x for x, _ in pts], cuda), _planes([y for _, y in pts], cuda)
    before = ladder.KERNEL.launches
    got = ladder.ladder_planes(s, xs, ys)
    assert ladder.KERNEL.launches == before + 1
    want = group.scalar_mult(s, JacobianPoint.from_affine(AffinePoint(xs, ys, P256)))
    for k, w in zip(got, (want.x.planes, want.y.planes, want.z.planes)):
        assert torch.equal(k, w)
    out = api.scalar_mult(s[:, :16].contiguous(), AffinePoint(
        xs[:, :16].contiguous(), ys[:, :16].contiguous(), P256))
    assert list(zip(ints(out.x), ints(out.y))) == [
        coz.scalar_mult_affine(k, x, y, P256) for k, (x, y) in zip(ks[:16], pts[:16])]


def test_affine_kernel_matches_plain_and_oracle(cuda):
    ks, s = _scalars(1024, 43, cuda)
    tables, negbase, _ = comb.device_tables(P256, P256.gx, P256.gy, cuda)
    x, y, z = comb.comb_plain(s, tables, P256, negbase)
    z[:, 0] = 0  # a lane at infinity maps to (0, 0)
    jac = JacobianPoint(*(GFp(t, P256.field) for t in (x, y, z)), P256)
    before = affine.KERNEL.launches
    got = affine.affine_planes(x, y, z)
    assert affine.KERNEL.launches == before + 1
    want = jac.to_affine()
    assert torch.equal(got[0], want.x) and torch.equal(got[1], want.y)
    assert list(zip(ints(got[0][:, :16]), ints(got[1][:, :16]))) == [(0, 0)] + [
        coz.scalar_mult_affine(k, P256.gx, P256.gy, P256) for k in ks[1:16]]
