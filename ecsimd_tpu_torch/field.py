"""L3: GF(p) prime-field value type for plain-domain Solinas fields.

The port of ``ecsimd_tpu/field.py``'s ``GFp``: a dataclass around (D, *batch)
int32 digit planes, values in [0, p), with operator sugar, constant powers
and inversion. Each operation widens to int64 planes, runs the digit-plane
ops of ``ops/`` and narrows back, so the stored planes keep the JAX
package's int32 interface. Montgomery (CIOS) and Crandall fields are not
ported yet and raise ``NotImplementedError`` (ROADMAP A6).
"""

from __future__ import annotations

import dataclasses

import torch

from ecsimd_tpu_torch.specs import FieldSpec, int_to_digits
from ecsimd_tpu_torch.ops import bignum as bn
from ecsimd_tpu_torch.ops import mont, solinas

I32 = torch.int32
I64 = torch.int64


def _wide(planes):
    return planes.to(I64)


@dataclasses.dataclass(frozen=True, eq=False)
class GFp:
    """A batch of field elements as plain-domain digit planes."""

    planes: torch.Tensor  # (D, *batch) int32, digits in [0, 2^16), value in [0, p)
    fs: FieldSpec

    def __post_init__(self):
        if self.fs.reduction != "solinas":
            raise NotImplementedError(
                f"{self.fs.name}: {self.fs.reduction} reduction is not ported to "
                "PyTorch yet (ROADMAP A6: CIOS and Crandall fields)"
            )

    @classmethod
    def _of(cls, wide_planes, fs: FieldSpec) -> "GFp":
        return cls(wide_planes.to(I32), fs)

    # -- constructors --------------------------------------------------------

    @classmethod
    def from_classical(cls, planes, fs: FieldSpec) -> "GFp":
        """Classical planes -> internal domain (the identity for the plain
        Solinas fields)."""
        return cls(planes, fs)

    @classmethod
    def constant(cls, value: int, fs: FieldSpec, like) -> "GFp":
        c = mont._const_planes(int_to_digits(value % fs.p, fs.ndigits), like)
        return cls(c.expand(like.shape).to(I32), fs)

    @classmethod
    def one(cls, fs: FieldSpec, like) -> "GFp":
        return cls.constant(1, fs, like)

    # -- accessors -----------------------------------------------------------

    def to_classical(self):
        return self.planes

    # -- arithmetic ----------------------------------------------------------

    def __add__(self, o: "GFp") -> "GFp":
        return GFp._of(mont.mod_add(_wide(self.planes), _wide(o.planes), self.fs), self.fs)

    def __sub__(self, o: "GFp") -> "GFp":
        return GFp._of(mont.mod_sub(_wide(self.planes), _wide(o.planes), self.fs), self.fs)

    def __mul__(self, o: "GFp") -> "GFp":
        return self.mul_scaled(o, 1)

    def sqr(self) -> "GFp":
        return self.sqr_scaled(1)

    def mul_scaled(self, o: "GFp", scale: int) -> "GFp":
        """scale * self * o for a small constant scale, fused into the
        Solinas reduction."""
        out = solinas.fast_mul(_wide(self.planes), _wide(o.planes), self.fs, scale)
        return GFp._of(out, self.fs)

    def sqr_scaled(self, scale: int) -> "GFp":
        return GFp._of(solinas.fast_sqr(_wide(self.planes), self.fs, scale), self.fs)

    def double(self) -> "GFp":
        return GFp._of(mont.mod_shift_left_one(_wide(self.planes), self.fs), self.fs)

    def shift_left(self, count: int) -> "GFp":
        """x * 2^count by repeated modular doubling."""
        a = _wide(self.planes)
        for _ in range(count):
            a = mont.mod_shift_left_one(a, self.fs)
        return GFp._of(a, self.fs)

    def opposite(self) -> "GFp":
        """-x mod p."""
        return GFp._of(mont.mod_opposite(_wide(self.planes), self.fs), self.fs)

    def pow_const(self, e: int) -> "GFp":
        """x^e for a public exponent: left-to-right square-and-multiply.
        The exponent is a host integer, so its bits steer Python control
        flow; the value equals the JAX package's masked loop."""
        if e == 0:
            return GFp.one(self.fs, self.planes)
        acc = self
        for bit in bin(e)[3:]:
            acc = acc.sqr()
            if bit == "1":
                acc = acc * self
        return acc

    def inverse(self) -> "GFp":
        """Fermat inversion x^(p-2). inverse(0) = 0."""
        return self.pow_const(self.fs.fermat_exponent)

    def batch_inverse(self) -> "GFp":
        """Montgomery-trick inversion over the batch axis: a pairwise
        product tree down the (flattened) batch, one inversion of the
        root, then the unwind inv_left = inv_parent * right, inv_right =
        inv_parent * left. Zero lanes are masked to 1 inside the product
        and back to 0 on the way out, so inverse(0) = 0 per lane.

        The root is inverted on the tensors' device by the Fermat chain of
        ``inverse``, as in the JAX package: nothing leaves the device and
        the work does not depend on the values."""
        fs = self.fs
        d = fs.ndigits
        flat = _wide(self.planes).reshape(d, -1)
        b = flat.shape[1]
        zero = bn.is_zero(flat)
        one = mont._const_planes(int_to_digits(1, d), flat).expand(d, b)
        a = bn.select(zero, one, flat)
        bp = 1 << (b - 1).bit_length()
        if bp != b:
            a = torch.cat([a, one[:, :1].expand(d, bp - b)], dim=1)

        pairs = []
        cur = a
        while cur.shape[1] > 1:
            left, right = cur[:, 0::2], cur[:, 1::2]
            pairs.append((left, right))
            cur = solinas.fast_mul(left, right, fs)

        inv = _wide(GFp._of(cur, fs).inverse().planes)
        for left, right in reversed(pairs):
            inv_l = solinas.fast_mul(inv, right, fs)
            inv_r = solinas.fast_mul(inv, left, fs)
            inv = torch.stack([inv_l, inv_r], dim=2).reshape(d, -1)

        out = bn.select(zero, torch.zeros_like(flat), inv[:, :b])
        return GFp._of(out.reshape(self.planes.shape), fs)

    # -- comparison and selection ------------------------------------------------

    def is_zero(self):
        """Per-lane int64 0/1 mask of x == 0 (values are canonical)."""
        return bn.is_zero(self.planes)

    def eq(self, o: "GFp"):
        """Per-lane int64 0/1 mask of x == o (the JAX package's ``==``)."""
        return bn.cmp_eq(self.planes, o.planes)

    def select(self, mask, other: "GFp") -> "GFp":
        """mask ? self : other, per lane."""
        return GFp(bn.select(mask, self.planes, other.planes), self.fs)

    def const_like(self, value: int) -> "GFp":
        """Field constant shaped like self."""
        return GFp.constant(value, self.fs, self.planes)


def gfp_swap_if(mask, a: GFp, b: GFp):
    """Constant-time masked swap."""
    s, t = bn.swap_if(mask, a.planes, b.planes)
    return GFp(s, a.fs), GFp(t, b.fs)
