"""The port's affine conversion (kernels/affine.py) on the CPU, where it runs
its plain version JacobianPoint.to_affine, against the JAX package's
JacobianPoint.to_affine in both of its forms (the batch inversion and the
per-lane Fermat power that kernel D computes) and against the Python-int
oracle. Jacobian inputs are (x z^2, y z^3, z) for affine multiples of G and
seeded random z, with one lane at infinity (z = 0 -> (0, 0)). Tolerance:
exact."""

import jax.numpy as jnp
import numpy as np
import pytest

from ecsimd_tpu.curves.point import JacobianPoint as JJacobian
from ecsimd_tpu.field import GFp as JGFp
from ecsimd_tpu.oracle import coz as ocoz
from ecsimd_tpu.specs import P256
from ecsimd_tpu_torch.curves.point import JacobianPoint
from ecsimd_tpu_torch.field import GFp
from ecsimd_tpu_torch.kernels import affine
from tests.toy import TOY64
from tests.torch_helpers import ints, multiples, planes, rand_ints, tplanes

N = 8


def _jacobians(curve, seed):
    """(x z^2, y z^3, z) columns: lane 0 at infinity, the rest (i+1)G."""
    p = curve.p
    zs = [0] + [z + 1 for z in rand_ints(np.random.default_rng(seed), p - 1, N - 1)]
    pts = [(0, 1)] + multiples(curve, N - 1)
    return [[x * z * z % p for (x, _), z in zip(pts, zs)],
            [y * z * z * z % p for (_, y), z in zip(pts, zs)], zs]


@pytest.mark.parametrize("curve", [TOY64, P256], ids=lambda c: c.name)
def test_to_affine_matches_oracle(curve):
    cols = _jacobians(curve, 60)
    d, fs = curve.field.ndigits, curve.field
    jac = JacobianPoint(*(GFp(tplanes(c, d), fs) for c in cols), curve)
    before = affine.KERNEL.launches
    out = affine.to_affine(jac)
    assert affine.KERNEL.launches == before  # CPU tensors never launch
    want = [(0, 0)] + [ocoz.jacobian_to_affine(t, curve) for t in zip(*(c[1:] for c in cols))]
    assert list(zip(ints(out.x), ints(out.y))) == want


def test_to_affine_matches_jax_toy64():
    cols = _jacobians(TOY64, 61)
    d, fs = TOY64.field.ndigits, TOY64.field
    port = affine.to_affine(JacobianPoint(*(GFp(tplanes(c, d), fs) for c in cols), TOY64))
    jjac = JJacobian(*(JGFp.from_classical(jnp.asarray(planes(c, d)), fs) for c in cols), TOY64)
    ref = jjac.to_affine(batch_inv=False)  # the per-lane Fermat power of kernel D
    np.testing.assert_array_equal(port.x.numpy(), np.asarray(ref.x))
    np.testing.assert_array_equal(port.y.numpy(), np.asarray(ref.y))


def test_affine_kernel_takes_cuda_tensors_only():
    d = P256.field.ndigits
    one = tplanes([1], d)
    with pytest.raises(ValueError, match="CUDA"):
        affine.affine_planes(one, one, one)
