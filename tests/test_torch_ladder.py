"""The port's co-Z ladder — the plain version of kernel A — against the JAX
package's group.scalar_mult on the 4-digit toy curve, and against the
Python-int oracle on P-256 (edge scalars 1, 2, 5, n-2 and distinct points
(i+1)G, as bench.py verifies). Tolerance: exact.

The JAX P-256 ladder is not run here (it compiles for about a minute on the
CPU); the JAX suite holds the JAX ladder to the same oracle."""

import jax.numpy as jnp
import numpy as np
import pytest

from ecsimd_tpu.curves import group as jgroup
from ecsimd_tpu.curves.point import AffinePoint as JAffine
from ecsimd_tpu.curves.point import JacobianPoint as JJacobian
from ecsimd_tpu.oracle import coz as ocoz
from ecsimd_tpu.specs import P256
from ecsimd_tpu_torch import api
from ecsimd_tpu_torch.curves.point import AffinePoint
from ecsimd_tpu_torch.kernels import ladder
from tests.toy import TOY64
from tests.torch_helpers import ints, multiples, planes, rand_ints, tplanes

N = 8


def _inputs(curve, seed, edges=()):
    rng = np.random.default_rng(seed)
    ks = rand_ints(rng, curve.order - 2, N, edges=[e - 1 for e in edges])
    ks = [k + 1 for k in ks]  # k in [1, order - 1)
    return ks, multiples(curve, N)


def test_plain_ladder_matches_jax_toy64():
    ks, pts = _inputs(TOY64, 10, edges=[1, 2, 5])
    d = TOY64.field.ndigits
    xs, ys = [x for x, _ in pts], [y for _, y in pts]
    port = ladder.scalar_mult(tplanes(ks, d), AffinePoint(tplanes(xs, d), tplanes(ys, d), TOY64))
    jpt = JJacobian.from_affine(JAffine(jnp.asarray(planes(xs, d)), jnp.asarray(planes(ys, d)), TOY64))
    ref = jgroup.scalar_mult(jnp.asarray(planes(ks, d)), jpt, host_loop=True)
    for t, j in ((port.x, ref.x), (port.y, ref.y), (port.z, ref.z)):
        np.testing.assert_array_equal(t.planes.numpy(), np.asarray(j.planes))


def test_plain_ladder_p256_vs_oracle():
    ks, pts = _inputs(P256, 11, edges=[1, 2, 5, P256.order - 2])
    d = P256.field.ndigits
    xs, ys = [x for x, _ in pts], [y for _, y in pts]
    res = ladder.scalar_mult(tplanes(ks, d), AffinePoint(tplanes(xs, d), tplanes(ys, d), P256))
    want = [ocoz.scalar_mult(k, (x, y, 1), P256) for k, (x, y) in zip(ks, pts)]
    assert list(zip(ints(res.x.planes), ints(res.y.planes), ints(res.z.planes))) == want
    aff = res.to_affine()
    assert list(zip(ints(aff.x), ints(aff.y))) == [
        ocoz.jacobian_to_affine(w, P256) for w in want]


def test_api_scalar_mult_ints_toy64():
    ks, pts = _inputs(TOY64, 12, edges=[1, 2, 5])
    xs, ys = api.scalar_mult_ints(ks, [x for x, _ in pts], [y for _, y in pts], TOY64)
    assert list(zip(xs, ys)) == [
        ocoz.scalar_mult_affine(k, x, y, TOY64) for k, (x, y) in zip(ks, pts)]


def test_api_p256_entry_and_kernel_dispatch():
    g = api.generator_batch(TOY64, 2)
    with pytest.raises(ValueError, match="P-256"):
        api.scalar_mult_p256(api.scalars_from_ints([1, 2], TOY64), g)
    # the kernel entry point takes CUDA tensors only; CPU tensors go through
    # ladder.scalar_mult's plain branch instead
    s = api.scalars_from_ints([3], P256)
    p = api.generator_batch(P256, 1)
    with pytest.raises(ValueError, match="CUDA"):
        ladder.ladder_planes(s, p.x, p.y)
