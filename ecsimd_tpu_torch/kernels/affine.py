"""Jacobian -> affine: kernel D (``csrc/affine.cu``, P-256, secp256k1,
Wei25519, P-384 and P-521) and its wrapper.

The JAX package converts with plain XLA (``ecsimd_tpu/curves/point.py``
``JacobianPoint.to_affine``: one batch inversion through a product tree),
with no Pallas kernel. The plain PyTorch version is this package's
``JacobianPoint.to_affine``, which does the same; on the card that tree is
thousands of small launches, so kernel D inverts each lane's z with its own
Fermat power instead, and returns classical residues (leaving the
Montgomery form on secp256k1). Every result is a canonical residue, so the
two agree bit for bit, lanes at infinity (z = 0) giving (0, 0) in both.
"""

from __future__ import annotations

import torch

from ecsimd_tpu_torch.specs import P256, SECP256K1, WEI25519, CurveSpec
from ecsimd_tpu_torch.curves.point import AffinePoint, JacobianPoint
from ecsimd_tpu_torch.kernels import _build

KERNEL = _build.Kernel(
    symbol="ec_affine_p256",
    source="ecsimd_tpu_torch/csrc/affine.cu",
    replaces="ecsimd_tpu/curves/point.py:50 JacobianPoint.to_affine (XLA, no Pallas kernel)",
    n_pointers=5,
)
KERNEL_SECP256K1 = _build.Kernel(
    symbol="ec_affine_secp256k1",
    source="ecsimd_tpu_torch/csrc/affine.cu",
    replaces="ecsimd_tpu/curves/point.py:50 JacobianPoint.to_affine (secp256k1; XLA, no Pallas kernel)",
    n_pointers=5,
)
KERNEL_W25519 = _build.Kernel(
    symbol="ec_affine_w25519",
    source="ecsimd_tpu_torch/csrc/affine.cu",
    replaces="ecsimd_tpu/curves/point.py:50 JacobianPoint.to_affine (Wei25519; XLA, no Pallas kernel)",
    n_pointers=5,
)
KERNELS = {P256: KERNEL, SECP256K1: KERNEL_SECP256K1, WEI25519: KERNEL_W25519}
for _curve in _build.WIDE_CURVES:
    _tag, _name = _build.CURVE_TAGS[_curve]
    KERNELS[_curve] = _build.Kernel(
        symbol=f"ec_affine_{_tag}",
        source="ecsimd_tpu_torch/csrc/affine.cu",
        replaces=f"ecsimd_tpu/curves/point.py:50 JacobianPoint.to_affine ({_name}; XLA, no "
                 "Pallas kernel)",
        n_pointers=5,
    )


def affine_planes(x, y, z, curve: CurveSpec = P256):
    """Run kernel D on (D, B) int32 CUDA Jacobian planes (internal domain).
    Returns classical affine (ax, ay) planes."""
    _build.require_cuda(x, "affine")
    kernel = KERNELS.get(curve)
    if kernel is None:
        raise NotImplementedError(
            f"{curve.name}: the CUDA affine conversion covers P-256, secp256k1, Wei25519, P-384 "
            "and P-521")
    shape = (curve.field.ndigits, x.shape[-1])
    for name, t in (("x", x), ("y", y), ("z", z)):
        _build.check_planes(name, t, shape, x.device)
    ax, ay = (torch.empty(shape, dtype=torch.int32, device=x.device) for _ in range(2))
    _build.launch(kernel, [x, y, z, ax, ay], shape[1])
    kernel.count(shape[1])
    return ax, ay


def to_affine(pt: JacobianPoint) -> AffinePoint:
    """x / z^2, y / z^3: kernel D for CUDA tensors, the plain
    ``JacobianPoint.to_affine`` for CPU tensors."""
    if pt.x.planes.device.type == "cpu":
        return pt.to_affine()
    ax, ay = affine_planes(
        pt.x.planes.contiguous(), pt.y.planes.contiguous(), pt.z.planes.contiguous(), pt.curve
    )
    return AffinePoint(ax, ay, pt.curve)
