"""Strict (total-domain) variable-base routing, the port of
``ecsimd_tpu/kernels/glv.py:strict_varbase``.

The JAX package sends GLV-capable curves (a = 0, e.g. secp256k1) through its
GLV double-scalar kernel and every other curve through the strict window.
The GLV kernel and the CIOS field it needs are not ported yet, so those
curves raise here; every other curve goes to ``kernels/window.scalar_mult``
with ``strict=True`` (kernel E on the card). ECDH's shared secret uses it.
"""

from __future__ import annotations

from ecsimd_tpu_torch.curves.point import AffinePoint, JacobianPoint
from ecsimd_tpu_torch.glv import glv_capable
from ecsimd_tpu_torch.kernels import window


def strict_varbase(scalars, pt: AffinePoint) -> JacobianPoint:
    """k_i * P_i over the whole scalar domain [1, order)."""
    if glv_capable(pt.curve):
        raise NotImplementedError(
            f"{pt.curve.name}: the GLV double-scalar kernel is not ported yet (ROADMAP B4)"
        )
    return window.scalar_mult(scalars, pt, strict=True)
