"""L2: modular add/sub/double/negate and the product grid over digit planes.

The port of the helpers of ``ecsimd_tpu/ops/mont.py`` that the plain-domain
(Solinas) fields use. Montgomery CIOS reduction is not ported yet (ROADMAP
A6). Operands are int64 planes with digits in [0, 2^16) and values in
[0, p) (see ``ops/bignum.py`` for why int64).
"""

from __future__ import annotations

import functools

import torch

from ecsimd_tpu_torch.specs import DIGIT_BITS, DIGIT_MASK, FieldSpec
from ecsimd_tpu_torch.ops import bignum as bn

I64 = torch.int64


@functools.cache
def _const_column(digits: tuple[int, ...], device: torch.device):
    """A constant digit tuple as a (D, 1) int64 column on ``device``,
    cached so that hot loops do not copy it from the host every call."""
    return torch.tensor(digits, dtype=I64, device=device).unsqueeze(1)


def _const_planes(digits, like):
    """Constant digits shaped (D, 1, ..) to broadcast over ``like``'s batch."""
    col = _const_column(tuple(int(x) for x in digits), like.device)
    return col.reshape((len(digits),) + (1,) * (like.dim() - 1))


def p_planes(fs: FieldSpec, like):
    return _const_planes(fs.p_digits, like)


def _cond_sub_p(s, carry, fs: FieldSpec):
    """Subtract p iff carry-out or s >= p (one conditional subtract)."""
    d, borrow = bn.sub(s, p_planes(fs, s))
    return bn.select(carry | (1 - borrow), d, s)


def mod_add(a, b, fs: FieldSpec):
    """(a + b) mod p for a, b in [0, p)."""
    s, carry = bn.add(a, b)
    return _cond_sub_p(s, carry, fs)


def mod_sub(a, b, fs: FieldSpec):
    """(a - b) mod p for a, b in [0, p)."""
    d, borrow = bn.sub(a, b)
    dd, _ = bn.add(d, p_planes(fs, d))
    return bn.select(borrow, dd, d)


def mod_shift_left_one(a, fs: FieldSpec):
    """(2a) mod p for a in [0, p)."""
    s, carry = bn.shift_left_one(a)
    return _cond_sub_p(s, carry, fs)


def mod_opposite(a, fs: FieldSpec):
    """(-a) mod p for a in [0, p); 0 stays 0."""
    d, _ = bn.sub(p_planes(fs, a).expand_as(a), a)
    return bn.select(bn.is_zero(a), a, d)


def _product_columns(a, b):
    """Schoolbook product grid as redundant columns, shape (2D+1, *batch).

    Each 16x16-bit product (< 2^32) is accumulated exactly in int64, one
    (D, *batch) row product per digit of ``a``, so temporaries stay
    O(D * batch). The column sums (< D * 2^32) are then split once into a
    low 16-bit part and a high part carried into the next column, which
    leaves every column below 2^16 + 2^21 < 2^22 — the column bound the
    Solinas reduction plan is proven for. The represented value is the
    exact product, so the reduction returns the same canonical residue as
    the JAX package's lo/hi grid."""
    d = a.shape[0]
    full = torch.zeros((2 * d + 1,) + a.shape[1:], dtype=I64, device=a.device)
    for i, ai in enumerate(a.unbind(0)):
        full[i : i + d] += ai * b
    cols = full & DIGIT_MASK
    cols[1:] += full[:-1] >> DIGIT_BITS
    return cols
