"""L4: batched curve points.

Affine points hold classical-domain planes; Jacobian points hold GFp
coordinates (the port of ``ecsimd_tpu/curves/point.py``).
"""

from __future__ import annotations

import dataclasses

import torch

from ecsimd_tpu.specs import CurveSpec
from ecsimd_tpu_torch.field import GFp


@dataclasses.dataclass(frozen=True, eq=False)
class AffinePoint:
    """Batched affine point, classical-domain planes."""

    x: torch.Tensor  # (D, *batch) int32
    y: torch.Tensor
    curve: CurveSpec


@dataclasses.dataclass(frozen=True, eq=False)
class JacobianPoint:
    """Batched Jacobian point (X/Z^2, Y/Z^3)."""

    x: GFp
    y: GFp
    z: GFp
    curve: CurveSpec

    @classmethod
    def from_affine(cls, pt: AffinePoint) -> "JacobianPoint":
        """z = 1."""
        fs = pt.curve.field
        x = GFp.from_classical(pt.x, fs)
        y = GFp.from_classical(pt.y, fs)
        return cls(x, y, GFp.one(fs, x.planes), pt.curve)

    def to_affine(self) -> AffinePoint:
        """x/z^2, y/z^3, sharing one inversion across the batch
        (GFp.batch_inverse). Lanes at infinity (z == 0) map to (0, 0)."""
        zi = self.z.batch_inverse()
        zi2 = zi.sqr()
        ax = self.x * zi2
        ay = self.y * zi2 * zi
        return AffinePoint(ax.to_classical(), ay.to_classical(), self.curve)

    def opposite(self) -> "JacobianPoint":
        """(x, -y, z)."""
        return JacobianPoint(self.x, self.y.opposite(), self.z, self.curve)

    def select(self, mask, other: "JacobianPoint") -> "JacobianPoint":
        """Per-lane mask ? self : other."""
        return JacobianPoint(
            self.x.select(mask, other.x),
            self.y.select(mask, other.y),
            self.z.select(mask, other.z),
            self.curve,
        )
