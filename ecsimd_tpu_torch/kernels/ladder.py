"""The co-Z ladder k_i * P_i: kernel A (``csrc/ladder.cu`` on P-256,
secp256k1 and Wei25519, ``csrc/ladder_p384.cu`` and ``ladder_p521.cu``)
and its wrapper.

Replaces ``ecsimd_tpu/kernels/ladder.py`` (``ladder_mont_planes`` and its
Pallas body ``_ladder_kernel``). The plain PyTorch version is
``curves/group.scalar_mult``: the same formula sequence, so the kernel's
Jacobian planes equal it bit for bit. Both take the point's coordinates in
the field's internal form (Montgomery form on secp256k1), as
``ladder_mont_planes`` does; ``scalar_mult`` converts them.

There is no batch padding: each CUDA thread owns one lane and lanes past
the end return at once. The JAX package's lane-0 padding
(``parallel.pad_batch``) served only the TPU's block shapes.
"""

from __future__ import annotations

import torch

from ecsimd_tpu_torch.specs import P256, SECP256K1, WEI25519, CurveSpec
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
KERNEL_SECP256K1 = _build.Kernel(
    symbol="ec_ladder_secp256k1",
    source="ecsimd_tpu_torch/csrc/ladder.cu",
    replaces="ecsimd_tpu/kernels/ladder.py:116 _ladder_kernel (secp256k1)",
    n_pointers=6,
)
KERNEL_W25519 = _build.Kernel(
    symbol="ec_ladder_w25519",
    source="ecsimd_tpu_torch/csrc/ladder.cu",
    replaces="ecsimd_tpu/kernels/ladder.py:116 _ladder_kernel (Wei25519)",
    n_pointers=6,
)
KERNELS = {P256: KERNEL, SECP256K1: KERNEL_SECP256K1, WEI25519: KERNEL_W25519}
for _curve in _build.WIDE_CURVES:
    _tag, _name = _build.CURVE_TAGS[_curve]
    KERNELS[_curve] = _build.Kernel(
        symbol=f"ec_ladder_{_tag}",
        source=f"ecsimd_tpu_torch/csrc/ladder_{_tag}.cu",
        replaces=f"ecsimd_tpu/kernels/ladder.py:116 _ladder_kernel ({_name})",
        n_pointers=6,
    )


def ladder_planes(scalars, xm, ym, curve: CurveSpec = P256):
    """Run kernel A on (D, B) int32 CUDA planes: classical scalars and the
    affine (z = 1) point's coordinates in the field's internal form.
    Returns Jacobian (ax, ay, z) internal-form planes."""
    _build.require_cuda(scalars, "ladder")
    kernel = KERNELS.get(curve)
    if kernel is None:
        raise NotImplementedError(
            f"{curve.name}: the CUDA ladder covers P-256, secp256k1, Wei25519, P-384 and P-521")
    shape = (curve.field.ndigits, scalars.shape[-1])
    for name, t in (("scalars", scalars), ("x", xm), ("y", ym)):
        _build.check_planes(name, t, shape, scalars.device)
    ax, ay, z = (torch.empty(shape, dtype=torch.int32, device=scalars.device) for _ in range(3))
    _build.launch(kernel, [scalars, xm, ym, ax, ay, z], shape[1])
    kernel.launches += 1
    return ax, ay, z


def scalar_mult(scalars, pt: AffinePoint) -> JacobianPoint:
    """k_i * P_i for an affine batch (classical planes, converted to the
    field's internal form here): kernel A for CUDA tensors, the plain
    ``group.scalar_mult`` for CPU tensors. Returns Jacobian internal-form
    planes."""
    curve = pt.curve
    fs = curve.field
    xm = GFp.from_classical(pt.x, fs)
    ym = GFp.from_classical(pt.y, fs)
    if scalars.device.type == "cpu":
        return group.scalar_mult(scalars, JacobianPoint(xm, ym, GFp.one(fs, xm.planes), curve))
    ax, ay, z = ladder_planes(scalars.contiguous(), xm.planes.contiguous(),
                              ym.planes.contiguous(), curve)
    return JacobianPoint(GFp(ax, fs), GFp(ay, fs), GFp(z, fs), curve)
