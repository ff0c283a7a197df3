"""The reduction tree of multi-scalar multiplication: kernel M
(``csrc/batch_sum.cu`` on P-256, secp256k1 and Wei25519,
``csrc/batch_sum_p384.cu`` and ``batch_sum_p521.cu``) and its wrapper.

The JAX package sums a batch with plain XLA (``ecsimd_tpu/curves/group.py``
``batch_sum``: log2 B levels of the complete add, no Pallas kernel). The
plain PyTorch version is this package's ``group.batch_sum``; on the card
each of its levels is ~30 field operations of many small launches, so kernel
M runs a level in one launch: output lane i = lane i + lane i + n // 2, an
odd last lane carried, the JAX package's tree and formulas. Every field
result is canonical, so the two agree bit for bit, the output's Jacobian
representative included.
"""

from __future__ import annotations

import torch

from ecsimd_tpu_torch.curves import group
from ecsimd_tpu_torch.curves.point import JacobianPoint
from ecsimd_tpu_torch.field import GFp
from ecsimd_tpu_torch.kernels import _build
from ecsimd_tpu_torch.specs import CurveSpec

KERNELS = {}
for _curve in _build.CURVES:
    _tag, _name = _build.CURVE_TAGS[_curve]
    _source = "batch_sum.cu" if _curve in _build.CURVES_256 else f"batch_sum_{_tag}.cu"
    KERNELS[_curve] = _build.Kernel(
        symbol=f"ec_batch_sum_{_tag}",
        source=f"ecsimd_tpu_torch/csrc/{_source}",
        replaces="ecsimd_tpu/curves/group.py:367 batch_sum" + (
            f" ({_name}; XLA, no Pallas kernel)" if _name else " (XLA, no Pallas kernel)"),
        n_pointers=6,
    )


def level_planes(x, y, z, curve: CurveSpec):
    """One launch of kernel M on (D, n) int32 CUDA Jacobian planes (internal
    form), n >= 2: returns the next level's (D, (n + 1) // 2) planes."""
    _build.require_cuda(x, "batch_sum")
    kernel = KERNELS.get(curve)
    if kernel is None:
        raise NotImplementedError(
            f"{curve.name}: the CUDA batch sum covers P-256, secp256k1, Wei25519, P-384 and "
            "P-521")
    d, n = curve.field.ndigits, x.shape[-1]
    if n < 2:
        raise ValueError(f"batch_sum: a level takes at least 2 lanes, got {n}")
    for name, t in (("x", x), ("y", y), ("z", z)):
        _build.check_planes(name, t, (d, n), x.device)
    out = [torch.empty((d, n - n // 2), dtype=torch.int32, device=x.device) for _ in range(3)]
    _build.launch(kernel, [x, y, z, *out], n)
    kernel.count(n)
    return tuple(out)


def batch_sum_planes(x, y, z, curve: CurveSpec):
    """Kernel M level by level, ceil(log2 n) launches: (D, n) Jacobian
    planes -> the (D, 1) planes of their sum."""
    while x.shape[-1] > 1:
        x, y, z = level_planes(x, y, z, curve)
    return x, y, z


def batch_sum(pt: JacobianPoint) -> JacobianPoint:
    """The sum of a flat (D, B) Jacobian batch as a 1-lane batch (it may be
    the point at infinity, z = 0): kernel M for CUDA tensors, the plain
    ``group.batch_sum`` for CPU tensors."""
    if pt.x.planes.device.type == "cpu":
        return group.batch_sum(pt)
    if pt.x.planes.ndim != 2:
        raise ValueError("batch_sum expects flat (D, B) planes")
    fs = pt.curve.field
    x, y, z = batch_sum_planes(pt.x.planes.contiguous(), pt.y.planes.contiguous(),
                               pt.z.planes.contiguous(), pt.curve)
    return JacobianPoint(GFp(x, fs), GFp(y, fs), GFp(z, fs), pt.curve)
