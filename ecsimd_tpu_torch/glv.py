"""GLV host gate (the port of ``ecsimd_tpu/glv.py``'s ``glv_capable``).

Only the gate is ported: ``kernels/glv.strict_varbase`` uses it to refuse
the curves whose strict variable-base path is the GLV double-scalar kernel,
which is not ported yet (ROADMAP B4, with the CIOS field).
"""

from __future__ import annotations

import functools

from ecsimd_tpu_torch.specs import CurveSpec


@functools.cache
def glv_capable(curve: CurveSpec) -> bool:
    """Cheap host-side gate: can the GLV split be derived for this curve
    (a = 0, p = n = 1 mod 3, exact order)?"""
    return (
        curve.a == 0 and curve.order_exact
        and curve.p % 3 == 1 and curve.order % 3 == 1
    )
