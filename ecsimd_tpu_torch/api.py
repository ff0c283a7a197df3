"""L6: batched scalar-multiplication entry points.

The port of ``ecsimd_tpu/api.py``'s main path. Every function runs on the
device of its input tensors: on a CUDA tensor through the hand-written
kernels (``kernels/ladder.py``, ``kernels/window.py`` and ``kernels/glv.py``
for k_i * P_i, ``kernels/comb.py`` for k_i * B, then ``kernels/affine.py``
for the affine conversion), on a CPU tensor through their plain PyTorch
versions. Both give
the same planes, so the affine results equal the JAX package's.
The constructors take ``device=`` and default to the card: with no card
they raise, and the CPU is used only when the caller asks for it.
"""

from __future__ import annotations

import torch

from ecsimd_tpu_torch import convert
from ecsimd_tpu_torch.curves.point import AffinePoint
from ecsimd_tpu_torch.kernels import affine, comb, glv, ladder, window
from ecsimd_tpu_torch.specs import P256, CurveSpec


def scalar_mult(scalars, points: AffinePoint) -> AffinePoint:
    """Batched constant-time k_i * P_i (the co-Z masked-swap ladder).
    Scalar domain k in [1, order-1)."""
    return affine.to_affine(ladder.scalar_mult(scalars, points))


def scalar_mult_p256(scalars, points: AffinePoint) -> AffinePoint:
    """k_i * P_i on NIST P-256."""
    if points.curve != P256:
        raise ValueError(f"scalar_mult_p256 takes P-256 points, got {points.curve.name}")
    return scalar_mult(scalars, points)


def scalar_mult_fast(scalars, points: AffinePoint, strict: bool = False) -> AffinePoint:
    """Batched constant-time k_i * P_i through the signed w = 4 window
    (masked lookups). Scalar domain: [1, order-1) minus a measure-zero
    degenerate class (``kernels/window.py``); ``strict=True`` uses complete
    adds and takes all of [1, order)."""
    return affine.to_affine(window.scalar_mult(scalars, points, strict=strict))


def scalar_mult_glv(scalars, points: AffinePoint, strict: bool = True) -> AffinePoint:
    """Batched k_i * P_i through the GLV endomorphism split, the
    variable-base path of j-invariant-0 curves (secp256k1): k = k1 + k2
    lambda with |k_i| ~ sqrt(n) halves the doublings (``kernels/glv.py``).
    ``strict`` defaults True: k = lambda makes k1 = 0, so the degenerate
    classes are easy to reach."""
    return affine.to_affine(glv.scalar_mult(scalars, points, strict=strict))


def scalar_mult_shared_fast(k: int, points: AffinePoint) -> AffinePoint:
    """One host scalar k times every point of the batch: k broadcast into
    the planes that ``scalar_mult_fast`` takes."""
    d = points.curve.field.ndigits
    batch = points.x.shape[-1]
    scalars = torch.from_numpy(convert.broadcast_int(int(k), d, batch)).to(points.x.device)
    return scalar_mult_fast(scalars, points)


def scalar_mult_base(
    scalars, curve: CurveSpec = P256, base: tuple[int, int] | None = None,
    strict: bool = False,
) -> AffinePoint:
    """Fixed-base k_i * B for a base shared by every lane (default the
    curve generator) through the comb; tables are built on the host once per
    (curve, base, device). ``strict`` uses complete additions: scalar
    domain [1, order)."""
    return affine.to_affine(comb.scalar_mult_base(scalars, curve, base=base, strict=strict))


# --- host-friendly integer interfaces ----------------------------------------


def _to(planes, device) -> torch.Tensor:
    return torch.from_numpy(planes).to(torch.device(device))


def generator_batch(curve: CurveSpec, batch: int, device="cuda") -> AffinePoint:
    """The curve generator broadcast across a batch."""
    d = curve.field.ndigits
    gx = _to(convert.broadcast_int(curve.gx, d, 1), device)
    gy = _to(convert.broadcast_int(curve.gy, d, 1), device)
    return AffinePoint(gx.expand(d, batch).contiguous(), gy.expand(d, batch).contiguous(), curve)


def points_from_ints(xs, ys, curve: CurveSpec, device="cuda") -> AffinePoint:
    d = curve.field.ndigits
    return AffinePoint(
        _to(convert.ints_to_planes(xs, d), device),
        _to(convert.ints_to_planes(ys, d), device),
        curve,
    )


def scalars_from_ints(ks, curve: CurveSpec, device="cuda"):
    return _to(convert.ints_to_planes(ks, curve.field.ndigits), device)


def scalar_mult_ints(ks, xs, ys, curve: CurveSpec = P256, device="cuda"):
    """Pure-int convenience API: returns (x, y) int lists."""
    pts = points_from_ints(xs, ys, curve, device)
    res = scalar_mult(scalars_from_ints(ks, curve, device), pts)
    return convert.planes_to_ints(res.x.cpu().numpy()), convert.planes_to_ints(res.y.cpu().numpy())
