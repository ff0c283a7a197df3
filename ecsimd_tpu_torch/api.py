"""L6: batched scalar-multiplication entry points.

The port of ``ecsimd_tpu/api.py``'s main path. Every function runs on the
device of its input tensors: on a CUDA tensor through the hand-written
kernels (``kernels/ladder.py`` for k_i * P_i, ``kernels/comb.py`` for
k_i * B, then ``kernels/affine.py`` for the affine conversion), on a CPU
tensor through their plain PyTorch versions. Both give the same planes, so
the affine results equal the JAX package's.
The constructors take ``device=``.
"""

from __future__ import annotations

import torch

from ecsimd_tpu import convert
from ecsimd_tpu.specs import P256, CurveSpec
from ecsimd_tpu_torch.curves.point import AffinePoint
from ecsimd_tpu_torch.kernels import affine, comb, ladder


def scalar_mult(scalars, points: AffinePoint) -> AffinePoint:
    """Batched constant-time k_i * P_i (the co-Z masked-swap ladder).
    Scalar domain k in [1, order-1)."""
    return affine.to_affine(ladder.scalar_mult(scalars, points))


def scalar_mult_p256(scalars, points: AffinePoint) -> AffinePoint:
    """k_i * P_i on NIST P-256."""
    if points.curve != P256:
        raise ValueError(f"scalar_mult_p256 takes P-256 points, got {points.curve.name}")
    return scalar_mult(scalars, points)


def scalar_mult_base(
    scalars, curve: CurveSpec = P256, base: tuple[int, int] | None = None,
    strict: bool = False,
) -> AffinePoint:
    """Fixed-base k_i * B for a base shared by every lane (default the
    curve generator) through the comb; tables are built on the host once per
    (curve, base, device). ``strict`` (complete additions) is not ported yet."""
    return affine.to_affine(comb.scalar_mult_base(scalars, curve, base=base, strict=strict))


# --- host-friendly integer interfaces ----------------------------------------


def generator_batch(curve: CurveSpec, batch: int, device="cpu") -> AffinePoint:
    """The curve generator broadcast across a batch."""
    d = curve.field.ndigits
    gx = torch.from_numpy(convert.broadcast_int(curve.gx, d, 1)).to(device)
    gy = torch.from_numpy(convert.broadcast_int(curve.gy, d, 1)).to(device)
    return AffinePoint(gx.expand(d, batch).contiguous(), gy.expand(d, batch).contiguous(), curve)


def points_from_ints(xs, ys, curve: CurveSpec, device="cpu") -> AffinePoint:
    d = curve.field.ndigits
    return AffinePoint(
        torch.from_numpy(convert.ints_to_planes(xs, d)).to(device),
        torch.from_numpy(convert.ints_to_planes(ys, d)).to(device),
        curve,
    )


def scalars_from_ints(ks, curve: CurveSpec, device="cpu"):
    return torch.from_numpy(convert.ints_to_planes(ks, curve.field.ndigits)).to(device)


def scalar_mult_ints(ks, xs, ys, curve: CurveSpec = P256, device="cpu"):
    """Pure-int convenience API: returns (x, y) int lists."""
    pts = points_from_ints(xs, ys, curve, device)
    res = scalar_mult(scalars_from_ints(ks, curve, device), pts)
    return convert.planes_to_ints(res.x.cpu().numpy()), convert.planes_to_ints(res.y.cpu().numpy())
