"""ECDSA helpers that ECDH needs: the order field and the on-curve check.

The port of ``ecsimd_tpu/ecdsa.py:order_field`` and ``_on_curve`` only.
Signing, verification and recovery need the CIOS order-field arithmetic and
come with ROADMAP A6/A7.
"""

from __future__ import annotations

import functools

from ecsimd_tpu_torch.field import GFp
from ecsimd_tpu_torch.specs import CurveSpec, FieldSpec


@functools.cache
def order_field(curve: CurveSpec) -> FieldSpec:
    """GF(n) for the curve's (prime) group order, Montgomery reduction, as
    the JAX package builds it. The port uses only its digits (the range
    checks of ECDH); its arithmetic is not ported. Requires an exact
    order (``CurveSpec.order_exact``)."""
    assert curve.order_exact, (
        f"{curve.name}: order is a placeholder (order_exact=False); "
        "ECDSA/ECDH/MSM need the exact group order"
    )
    return FieldSpec(
        name=f"{curve.name}-order", p=curve.order,
        nbits=curve.field.nbits, reduction="montgomery",
    )


def _on_curve(qx: GFp, qy: GFp, curve: CurveSpec):
    """Per-lane int64 0/1 mask: y^2 == x^3 + a x + b in GF(p)."""
    a, b = qx.const_like(curve.a), qx.const_like(curve.b)
    lhs = qy.sqr()
    rhs = (qx.sqr() + a) * qx + b
    return lhs.eq(rhs)
