"""The port's int32 calibration (ecsimd_tpu_torch/bench/roofline.py): the
plain version of kernel I against the JAX package's Pallas _calib_kernel in
interpret mode, with int32 wraparound on random operands. Tolerance:
exact."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from ecsimd_tpu.bench import roofline as jroofline
from ecsimd_tpu_torch.bench import roofline


@pytest.mark.parametrize("reps", [4, 10])
def test_calib_plain_matches_jax_interpret(reps):
    """reps = 10 runs 8 steps in both: the TPU loop's 4-way unroll."""
    rng = np.random.default_rng(70 + reps)
    a, b = (rng.integers(-(1 << 31), 1 << 31, size=(8, 128), dtype=np.int64).astype(np.int32)
            for _ in range(2))
    want = pl.pallas_call(
        functools.partial(jroofline._calib_kernel, reps=reps),
        out_shape=jax.ShapeDtypeStruct(a.shape, jnp.int32), interpret=True,
    )(jnp.asarray(a), jnp.asarray(b))
    got = roofline.calib(torch.from_numpy(a), torch.from_numpy(b), reps)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert roofline.KERNEL.launches == 0  # CPU tensors take the plain route
    assert roofline.OPS_PER_REP == jroofline._OPS_PER_REP


def test_measure_int32_ceiling_refuses_the_cpu():
    with pytest.raises(ValueError, match="card"):
        roofline.measure_int32_ceiling(device="cpu")
