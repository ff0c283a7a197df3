"""L3: GF(p) prime-field value type over Solinas, Crandall and Montgomery
fields.

The port of ``ecsimd_tpu/field.py``'s ``GFp``: a dataclass around (D, *batch)
int32 digit planes, values in [0, p), with operator sugar, constant powers,
inversion and square roots. Solinas fields (P-256) and Crandall fields
(2^255 - 19, P-521) store plain residues; Montgomery fields (secp256k1,
every ECDSA order field) store x R mod p with R = 2^nbits, as the JAX
package does, so the planes agree bit for bit. Each operation widens to
int64 planes, runs the digit-plane ops of ``ops/`` and narrows back, so the
stored planes keep the JAX package's int32 interface.
"""

from __future__ import annotations

import dataclasses

import torch

from ecsimd_tpu_torch.specs import DIGIT_BITS, FieldSpec, int_to_digits
from ecsimd_tpu_torch.ops import bignum as bn
from ecsimd_tpu_torch.ops import crandall, mont, solinas

I32 = torch.int32
I64 = torch.int64


def _wide(planes):
    return planes.to(I64)


def _mul_planes(a, b, fs: FieldSpec, scale: int = 1):
    """scale * a * b in the field's internal domain. The plain-domain fields
    fuse the scale into their reduction; Montgomery fields scale by modular
    adds (``_scale``)."""
    if fs.reduction == "solinas":
        return solinas.fast_mul(a, b, fs, scale)
    if fs.reduction == "crandall":
        return crandall.fast_mul(a, b, fs, scale)
    assert scale == 1, "Montgomery fields scale by modular adds"
    return mont.mont_mul(a, b, fs)


def _one_planes(fs: FieldSpec, like):
    """The internal-domain 1 (R mod p for Montgomery fields), as int64
    planes shaped like ``like``."""
    one = fs.R_mod_p if not fs.plain else 1
    return mont._const_planes(int_to_digits(one, fs.ndigits), like).expand(like.shape)


def _scale(r: "GFp", scale: int) -> "GFp":
    """r * scale for the small constants the formulas fuse, by modular adds:
    the Montgomery reduction's t < R p contract forbids scaling the columns,
    and the residue is canonical either way."""
    out = r
    for _ in range(scale - 1):
        out = out + r
    return out


@dataclasses.dataclass(frozen=True, eq=False)
class GFp:
    """A batch of field elements as plain-domain digit planes."""

    planes: torch.Tensor  # (D, *batch) int32, digits in [0, 2^16), value in [0, p)
    fs: FieldSpec

    @classmethod
    def _of(cls, wide_planes, fs: FieldSpec) -> "GFp":
        return cls(wide_planes.to(I32), fs)

    # -- constructors --------------------------------------------------------

    @classmethod
    def from_classical(cls, planes, fs: FieldSpec) -> "GFp":
        """Classical planes -> internal domain (x R mod p for Montgomery
        fields, the identity for the plain Solinas fields)."""
        if fs.plain:
            return cls(planes, fs)
        return cls._of(mont.mont_from_classical(_wide(planes), fs), fs)

    @classmethod
    def from_mont(cls, planes, fs: FieldSpec) -> "GFp":
        """Planes already in the field's internal form (x R mod p on the
        Montgomery fields, the residue itself on the plain ones)."""
        return cls(planes, fs)

    @classmethod
    def constant(cls, value: int, fs: FieldSpec, like) -> "GFp":
        """A host constant, converted to the internal domain on the host."""
        m = value % fs.p if fs.plain else (value << fs.nbits) % fs.p
        c = mont._const_planes(int_to_digits(m, fs.ndigits), like)
        return cls(c.expand(like.shape).to(I32), fs)

    @classmethod
    def one(cls, fs: FieldSpec, like) -> "GFp":
        return cls.constant(1, fs, like)

    @classmethod
    def zero(cls, fs: FieldSpec, like) -> "GFp":
        return cls(torch.zeros_like(like), fs)

    # -- accessors -----------------------------------------------------------

    def to_classical(self):
        if self.fs.plain:
            return self.planes
        return mont.mont_to_classical(_wide(self.planes), self.fs).to(I32)

    # -- arithmetic ----------------------------------------------------------

    def __add__(self, o: "GFp") -> "GFp":
        return GFp._of(mont.mod_add(_wide(self.planes), _wide(o.planes), self.fs), self.fs)

    def __sub__(self, o: "GFp") -> "GFp":
        return GFp._of(mont.mod_sub(_wide(self.planes), _wide(o.planes), self.fs), self.fs)

    def __mul__(self, o: "GFp") -> "GFp":
        return GFp._of(_mul_planes(_wide(self.planes), _wide(o.planes), self.fs), self.fs)

    def sqr(self) -> "GFp":
        return self.sqr_scaled(1)

    def mul_scaled(self, o: "GFp", scale: int) -> "GFp":
        """scale * self * o for a small constant scale: fused into the
        Solinas or Crandall reduction, or doublings after a Montgomery
        multiply."""
        if not self.fs.plain:
            return _scale(self * o, scale)
        return GFp._of(_mul_planes(_wide(self.planes), _wide(o.planes), self.fs, scale), self.fs)

    def sqr_scaled(self, scale: int) -> "GFp":
        return self.mul_scaled(self, scale)

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

    def pow_planes(self, e_planes) -> "GFp":
        """x^e_i for a per-lane exponent (classical (D, *batch) digit
        planes), over every D 16 bits MSB first: a squaring and a multiply a
        bit, the product kept by the bit's mask: ``ops/mont.py``'s
        ``mont_pow_planes`` over the field's own multiply, as the JAX
        package's."""
        fs = self.fs
        am = _wide(self.planes)
        e = _wide(e_planes)
        acc = _one_planes(fs, am)
        for i in range(fs.ndigits * DIGIT_BITS):
            digit, off = divmod(fs.ndigits * DIGIT_BITS - 1 - i, DIGIT_BITS)
            ebit = (e[digit] >> off) & 1
            acc = _mul_planes(acc, acc, fs)
            acc = bn.select(ebit, _mul_planes(acc, am, fs), acc)
        return GFp._of(acc, fs)

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
        one = _one_planes(fs, flat)
        a = bn.select(zero, one, flat)
        bp = 1 << (b - 1).bit_length()
        if bp != b:
            a = torch.cat([a, one[:, :1].expand(d, bp - b)], dim=1)

        pairs = []
        cur = a
        while cur.shape[1] > 1:
            left, right = cur[:, 0::2], cur[:, 1::2]
            pairs.append((left, right))
            cur = _mul_planes(left, right, fs)

        inv = _wide(GFp._of(cur, fs).inverse().planes)
        for left, right in reversed(pairs):
            inv_l = _mul_planes(inv, right, fs)
            inv_r = _mul_planes(inv, left, fs)
            inv = torch.stack([inv_l, inv_r], dim=2).reshape(d, -1)

        out = bn.select(zero, torch.zeros_like(flat), inv[:, :b])
        return GFp._of(out.reshape(self.planes.shape), fs)

    def sqrt(self) -> tuple["GFp", torch.Tensor]:
        """Per-lane square root and an int64 0/1 mask of the lanes that have
        one (sqrt(0) = 0 with ok = 1), by the field's kind, as the JAX
        package dispatches on the public p:

          p = 3 (mod 4): x^((p+1)/4) — P-256 and secp256k1;
          p = 5 (mod 8): r = x^((p+3)/8), times sqrt(-1) where r^2 != x
          (the toy GLV field, 2^255 - 19);
          otherwise: Tonelli-Shanks with a fixed round schedule and masked
          multiplies (no data-dependent trips)."""
        fs = self.fs
        kind = fs.sqrt_kind
        if kind == "p3mod4":
            r = self.pow_const(fs.sqrt_exponent)
        elif kind == "p5mod8":
            r = self.pow_const((fs.p + 3) // 8)
            fixed = r * self.const_like(fs.sqrt_m1)
            r = r.select(r.sqr().eq(self), fixed)
        else:
            r = self._tonelli_shanks()
        return r, r.sqr().eq(self)

    def _tonelli_shanks(self) -> "GFp":
        """Constant-time Tonelli-Shanks: s - 1 fixed rounds, per-lane masked
        multiplies (the JAX package's ``_tonelli_shanks``)."""
        q, s, c_int = self.fs.ts_params
        c = self.const_like(c_int)
        t = self.pow_const(q)
        r = self.pow_const((q + 1) // 2)
        one = GFp.one(self.fs, self.planes)
        for i in range(s, 1, -1):
            b = t
            for _ in range(i - 2):
                b = b.sqr()
            e = b.eq(one)  # b == 1: this round is a no-op
            r = r.select(e, r * c)
            c = c.sqr()
            t = t.select(e, t * c)
        return r

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
