"""L2: modular arithmetic over digit planes: add/sub/double/negate, the
product grid, and Montgomery multiplication with CIOS reduction.

The port of ``ecsimd_tpu/ops/mont.py``. Montgomery radix R = 2^nbits, as in
the JAX package, with the digit-serial CIOS reduction and m' = -p^-1 mod
2^16, so a Montgomery-form plane here equals the JAX package's bit for bit.
Operands are int64 planes with digits in [0, 2^16) and values in [0, p)
(see ``ops/bignum.py`` for why int64); the redundant columns stay far below
2^62, so nothing wraps.
"""

from __future__ import annotations

import functools

import torch

from ecsimd_tpu_torch.specs import DIGIT_BITS, DIGIT_MASK, FieldSpec, int_to_digits
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


# --- Montgomery reduction / multiplication ------------------------------------


def _cios_reduce(cols, fs: FieldSpec):
    """Digit-serial CIOS Montgomery reduction of redundant columns
    (2D+1, *batch) of a value t < R p: returns t R^-1 mod p in [0, p).

    For each retired digit i: q = t_i m' mod 2^16 (the lower positions are
    already zero and their carries absorbed, so cols[i] is exact mod 2^16),
    add q p at position i, and push the now-zero position's carry up."""
    d = fs.ndigits
    p_vec = p_planes(fs, cols)
    cols = cols.clone()
    for i in range(d):
        q = (cols[i] * fs.mprime) & DIGIT_MASK
        prod = q.unsqueeze(0) * p_vec  # (D, *batch), each < 2^32
        cols[i : i + d] += prod & DIGIT_MASK
        cols[i + 1 : i + 1 + d] += prod >> DIGIT_BITS
        cols[i + 1] += cols[i] >> DIGIT_BITS
    # result = cols[d..2d] (value < 2p): normalize, then one conditional subtract
    r, carry = bn.normalize_signed(cols[d : 2 * d])
    return _cond_sub_p(r, carry + cols[2 * d], fs)


def mont_reduce(t, fs: FieldSpec):
    """Montgomery-reduce a 2D-digit normalized value t < R p."""
    return _cios_reduce(bn.pad(t, 2 * fs.ndigits + 1), fs)


def mont_mul(a, b, fs: FieldSpec):
    """a b R^-1 mod p: the product grid feeds CIOS in redundant form."""
    return _cios_reduce(_product_columns(a, b), fs)


def mont_sqr(a, fs: FieldSpec):
    """a^2 R^-1 mod p (the full grid, as the JAX package's XLA path)."""
    return mont_mul(a, a, fs)


def mont_from_classical(a, fs: FieldSpec):
    """a -> a R mod p = mont_mul(a, R^2 mod p)."""
    return mont_mul(a, _const_planes(fs.R2_digits(), a).expand_as(a), fs)


def mont_to_classical(am, fs: FieldSpec):
    """a R -> a: reduce the zero-extended value."""
    return mont_reduce(bn.pad(am, 2 * fs.ndigits), fs)


def mont_one(fs: FieldSpec, like):
    """R mod p, the Montgomery form of 1, shaped like ``like``."""
    return _const_planes(int_to_digits(fs.R_mod_p, fs.ndigits), like).expand_as(like)


def mont_pow_const(am, e: int, fs: FieldSpec):
    """Montgomery-form power with a public host exponent (classical e):
    left-to-right square-and-multiply. The bits steer Python control flow;
    every lane takes the same steps, and the values equal the JAX package's
    masked loop."""
    if e == 0:
        return mont_one(fs, am)
    acc = am
    for bit in bin(e)[3:]:
        acc = mont_sqr(acc, fs)
        if bit == "1":
            acc = mont_mul(acc, am, fs)
    return acc


def mont_pow_planes(am, e, fs: FieldSpec):
    """Per-lane exponent (e as (D, *batch) classical digit planes): every
    bit costs a squaring and a multiply, kept by a per-lane mask."""
    d = fs.ndigits
    acc = mont_one(fs, am)
    for i in range(d * DIGIT_BITS):
        bit_idx = d * DIGIT_BITS - 1 - i
        digit, off = divmod(bit_idx, DIGIT_BITS)
        ebit = (e[digit] >> off) & 1
        acc = mont_sqr(acc, fs)
        acc = bn.select(ebit, mont_mul(acc, am, fs), acc)
    return acc
