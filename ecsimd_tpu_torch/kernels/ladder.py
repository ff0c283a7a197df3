"""The co-Z ladder k_i * P_i: kernel A (``csrc/ladder.cu``) and its wrapper.

Replaces ``ecsimd_tpu/kernels/ladder.py`` (``ladder_mont_planes`` and its
Pallas body ``_ladder_kernel``). The plain PyTorch version is
``curves/group.scalar_mult``: the same formula sequence, so the kernel's
Jacobian planes equal it bit for bit.

There is no batch padding: each CUDA thread owns one lane and lanes past
the end return at once. The JAX package's lane-0 padding
(``parallel.pad_batch``) served only the TPU's block shapes.
"""

from __future__ import annotations

import torch

from ecsimd_tpu_torch.specs import P256, CurveSpec
from ecsimd_tpu_torch.curves import group
from ecsimd_tpu_torch.curves.point import AffinePoint, JacobianPoint
from ecsimd_tpu_torch.field import GFp
from ecsimd_tpu_torch.kernels import _build

KERNEL = _build.Kernel(
    symbol="ec_ladder_p256",
    source="ecsimd_tpu_torch/csrc/ladder.cu",
    replaces="ecsimd_tpu/kernels/ladder.py:116 _ladder_kernel",
    n_pointers=6,
)


def ladder_planes(scalars, xm, ym, curve: CurveSpec = P256):
    """Run kernel A on (D, B) int32 CUDA planes: classical scalars and
    affine (z = 1) point coordinates. Returns Jacobian (ax, ay, z) planes."""
    _build.require_cuda(scalars, "ladder")
    if curve != P256:
        raise NotImplementedError(
            f"{curve.name}: the CUDA ladder covers P-256 only (ROADMAP B0, other fields)"
        )
    shape = (curve.field.ndigits, scalars.shape[-1])
    for name, t in (("scalars", scalars), ("x", xm), ("y", ym)):
        _build.check_planes(name, t, shape, scalars.device)
    ax, ay, z = (torch.empty(shape, dtype=torch.int32, device=scalars.device) for _ in range(3))
    _build.launch(KERNEL, [scalars, xm, ym, ax, ay, z], shape[1])
    KERNEL.launches += 1
    return ax, ay, z


def scalar_mult(scalars, pt: AffinePoint) -> JacobianPoint:
    """k_i * P_i for an affine batch: kernel A for CUDA tensors, the plain
    ``group.scalar_mult`` for CPU tensors. Returns Jacobian planes."""
    if scalars.device.type == "cpu":
        return group.scalar_mult(scalars, JacobianPoint.from_affine(pt))
    fs = pt.curve.field
    ax, ay, z = ladder_planes(scalars.contiguous(), pt.x.contiguous(), pt.y.contiguous(), pt.curve)
    return JacobianPoint(GFp(ax, fs), GFp(ay, fs), GFp(z, fs), pt.curve)
