"""Fold reduction for Crandall primes p = 2^k - c (small c): 2^255 - 19 and
P-521's 2^521 - 1.

The port of ``ecsimd_tpu/ops/crandall.py``. The high product columns fold
down d digit positions with one small multiplier, cc = 2^nbits mod p
(= c << (nbits - k)); then bit folds at 2^k, value -> (value mod 2^k) +
c * (value >> k), bring the value under 2p for one conditional subtract.
Values are plain residues in [0, p), as on the Solinas fields, so every
result equals the JAX package's bit for bit (both are canonical).

The planes are int64 (``ops/bignum.py`` says why), so the JAX package's
signed int32 slot bookkeeping (offsets, split high columns, carry folds at
2^nbits) is not needed: one digit fold, one normalisation, and the bit
folds carry the normalisation's carry-out with them. ``_fold_plan`` proves
the bounds on the host, as the JAX ``_plan`` does for its own steps.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

from ecsimd_tpu_torch.specs import DIGIT_BITS, FieldSpec
from ecsimd_tpu_torch.ops import bignum as bn
from ecsimd_tpu_torch.ops import mont

NORMALIZE_DIGIT_BOUND = 1 << 46  # bn.normalize_signed's contract on |digit|


def grid_col_bound(fs: FieldSpec, scale: int = 1) -> int:
    """Upper bound for product-grid columns, the JAX package's: (2d + 2)
    scale 2^16. It holds for ``mont._product_columns`` too, whose columns
    are below (d + 1) 2^16 (one low half plus the carried high part)."""
    return (2 * fs.ndigits + 2) * scale << DIGIT_BITS


class _FoldPlan(NamedTuple):
    cc: int  # 2^nbits mod p = c << (nbits - k)
    c: int  # 2^k - p
    kr: int  # k - 16 (d - 1): bit offset of 2^k inside the top digit
    nbitfold: int  # bit folds at 2^k that bring the value under 2p


@functools.cache
def _fold_plan(fs: FieldSpec, ncols: int, col_bound: int) -> _FoldPlan:
    """Host interval proof for ``crandall_reduce`` on columns in
    [0, col_bound): every assert is a proved bound."""
    d = fs.ndigits
    k = fs.p.bit_length()
    c = (1 << k) - fs.p
    cc = (1 << fs.nbits) % fs.p
    assert c > 0 and cc == c << (fs.nbits - k), f"{fs.name}: not a Crandall prime"
    assert 0 < fs.nbits - k < DIGIT_BITS, "the top digit must hold bit k"
    assert ncols <= 2 * d + 1
    kr = k - DIGIT_BITS * (d - 1)

    # digit fold: column d + j adds cc times itself at digit j (j < d) or,
    # for j = d, at 2^nbits, i.e. to the normalisation's carry-out
    slot = [col_bound - 1 if s < ncols else 0 for s in range(d)]
    for j in range(max(0, ncols - d)):
        if j < d:
            slot[j] += cc * (col_bound - 1)
    assert max(slot) < NORMALIZE_DIGIT_BOUND, "digit fold overflows the normalisation"
    top = cc * (col_bound - 1) if ncols == 2 * d + 1 else 0
    bound = sum(s << (DIGIT_BITS * i) for i, s in enumerate(slot)) + (top << fs.nbits)

    nbitfold = 0
    while bound >= 2 * fs.p:
        hi_max = bound >> k
        assert (1 << DIGIT_BITS) + c * hi_max < NORMALIZE_DIGIT_BOUND, "bit-fold addend overflow"
        bound = min(bound, (1 << k) - 1) + c * hi_max
        nbitfold += 1
        assert nbitfold <= 4, f"{fs.name}: bit folds do not converge"
    return _FoldPlan(cc, c, kr, nbitfold)


def crandall_reduce(cols, fs: FieldSpec, col_bound: int | None = None):
    """Reduce redundant product columns (ncols, *batch), each in
    [0, col_bound), mod p to [0, p)."""
    if col_bound is None:
        col_bound = grid_col_bound(fs)
    d = fs.ndigits
    ncols = cols.shape[0]
    plan = _fold_plan(fs, ncols, col_bound)
    r = bn.pad(cols[: min(ncols, d)], d)
    nh = min(max(0, ncols - d), d)
    if nh:
        r[:nh] += plan.cc * cols[d : d + nh]
    w, carry = bn.normalize_signed(r)
    if ncols == 2 * d + 1:
        carry = carry + plan.cc * cols[2 * d]
    # value = w + carry 2^nbits; value >> k = (w[d-1] >> kr) + carry 2^(nbits - k)
    low = (1 << plan.kr) - 1
    for _ in range(plan.nbitfold):
        top = (w[d - 1] >> plan.kr) + (carry << (DIGIT_BITS - plan.kr))
        w = w.clone()
        w[d - 1] &= low
        w[0] += plan.c * top
        w, carry = bn.normalize_signed(w)
    return mont._cond_sub_p(w, carry, fs)


def fast_mul(a, b, fs: FieldSpec, scale: int = 1):
    """scale * a * b mod p (plain domain): the product grid and the fold.
    ``scale`` (a small positive constant) multiplies the columns first, and
    the fold's proof re-runs with the scaled bound."""
    cols = mont._product_columns(a, b)
    if scale != 1:
        cols = cols * scale
    return crandall_reduce(cols, fs, col_bound=grid_col_bound(fs, scale))


def fast_sqr(a, fs: FieldSpec, scale: int = 1):
    """scale * a^2 mod p. The port has no triangular squaring grid: the
    full grid gives the same canonical residue."""
    return fast_mul(a, a, fs, scale)
