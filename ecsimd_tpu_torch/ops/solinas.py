"""Multiply-free modular reduction for Solinas/NIST primes (P-256).

The port of ``ecsimd_tpu/ops/solinas.py``. The per-prime reduction matrix
is derived from p at run time: 2^(32h) mod p for each high word h, as a
small signed combination of low words. The planners below
(``_balanced_words``, ``reduction_matrix``, ``_plan``,
``_cbar_digit_terms``) are copies of the JAX package's pure-Python ones,
kept here so that this package never imports JAX; a test asserts that each
copy returns what the original returns.

Values are plain residues in [0, p) held as int64 digit planes.
"""

from __future__ import annotations

import functools

import torch

from ecsimd_tpu.specs import DIGIT_BITS, FieldSpec, int_to_digits
from ecsimd_tpu_torch.ops import bignum as bn
from ecsimd_tpu_torch.ops import mont

I64 = torch.int64
WORD_BITS = 32
DIGITS_PER_WORD = WORD_BITS // DIGIT_BITS


# --- planners (copied from ecsimd_tpu/ops/solinas.py) --------------------------


def _balanced_words(v: int, nwords: int) -> list[tuple[int, int]]:
    """v as a signed sum of +-small * 2^(32w): [(word, coeff)], |coeff| small."""
    out = []
    w = 0
    while v:
        d = v & 0xFFFFFFFF
        v >>= 32
        if d > 0x80000000:
            d -= 1 << 32
            v += 1
        if d:
            out.append((w, d))
        w += 1
    assert all(w < nwords + 1 for w, _ in out)
    return out


@functools.cache
def reduction_matrix(fs: FieldSpec) -> tuple[tuple[tuple[int, int], ...], ...]:
    """For each high word h = nwords..2*nwords: 2^(32h) mod p as a signed
    combination of low-word positions: matrix[h - nwords] = ((word, coeff), ...).

    Derivation: start with the unit vector at h; while any coefficient sits at
    a word >= nwords, replace it with coeff * cbar shifted down by nwords
    (cbar = 2^nbits mod p in balanced word form). Converges with small
    coefficients exactly when p is a Solinas prime (asserted)."""
    nwords = fs.nbits // WORD_BITS
    cbar = (1 << fs.nbits) % fs.p
    cw = _balanced_words(cbar, nwords)
    assert all(abs(c) <= 2 for _, c in cw), f"{fs.name}: not a Solinas prime"

    rows = []
    for h in range(nwords, 2 * nwords + 1):
        coeffs = {h: 1}
        for _ in range(64):
            high = [(w, c) for w, c in coeffs.items() if w >= nwords and c]
            if not high:
                break
            for w, c in high:
                del coeffs[w]
                for cw_w, cw_c in cw:
                    t = w - nwords + cw_w
                    coeffs[t] = coeffs.get(t, 0) + c * cw_c
        else:
            raise AssertionError(f"{fs.name}: reduction did not converge")
        assert all(abs(c) <= 8 for c in coeffs.values())
        # verify exactly against Python ints
        val = sum(c << (32 * w) for w, c in coeffs.items())
        assert val % fs.p == pow(2, 32 * h, fs.p), f"matrix row {h} wrong"
        rows.append(tuple(sorted((w, c) for w, c in coeffs.items() if c)))
    return tuple(rows)


@functools.cache
def _plan(fs: FieldSpec, ncols: int, col_bound: int, col_lo: int = 0):
    """Interval analysis: offset constant (multiple of p making the
    combined value provably nonnegative) and bounds for each stage.

    Input columns lie in [col_lo, col_bound) — col_lo may be negative for
    fused multi-term reductions (kernels/digits.reduce_combo)."""
    d = fs.ndigits
    nwords = d // DIGITS_PER_WORD
    mat = reduction_matrix(fs)

    # per-output-digit signed bounds of the combination
    lo = [col_lo] * d
    hi = [col_bound] * d  # identity part: cols[k] in [col_lo, col_bound)
    for dk in range(d, ncols):
        h, par = divmod(dk, DIGITS_PER_WORD)
        for w, c in mat[h - nwords]:
            k = w * DIGITS_PER_WORD + par
            lo[k] += min(c * col_lo, c * col_bound)
            hi[k] += max(c * col_lo, c * col_bound)
    min_value = sum(l << (DIGIT_BITS * k) for k, l in enumerate(lo))
    max_value = sum(h << (DIGIT_BITS * k) for k, h in enumerate(hi))
    # offset = m*p >= -min_value so the folded value is nonnegative
    m = (-min_value + fs.p - 1) // fs.p if min_value < 0 else 0
    offset_digits = int_to_digits(m * fs.p, d + 2)
    assert offset_digits[d + 1] == 0, "offset exceeds one extra digit"
    offset_digits = offset_digits[: d + 1]
    assert min(lo) > -(1 << 30) and max(hi) < (1 << 30), "combination overflow"
    assert max(hi) + max(offset_digits) < (1 << 31), "digit overflow"
    c1_max = (max_value + m * fs.p) >> fs.nbits
    return mat, offset_digits, c1_max


@functools.cache
def _cbar_digit_terms(fs: FieldSpec):
    nwords = fs.nbits // WORD_BITS
    cbar = (1 << fs.nbits) % fs.p
    return tuple((w * DIGITS_PER_WORD, c) for w, c in _balanced_words(cbar, nwords))


# --- reduction ---------------------------------------------------------------


@functools.cache
def _combine_terms(fs: FieldSpec, ncols: int, device: torch.device):
    """The reduction matrix as three flat tensors (target digit, source
    column, coefficient), one entry per nonzero term, so that folding every
    high column into the low digits is one gather, one multiply and one
    ``index_add``."""
    d = fs.ndigits
    nwords = d // DIGITS_PER_WORD
    mat = reduction_matrix(fs)
    dst, src, coef = [], [], []
    for dk in range(d, ncols):
        h, par = divmod(dk, DIGITS_PER_WORD)
        for w, c in mat[h - nwords]:
            dst.append(w * DIGITS_PER_WORD + par)
            src.append(dk)
            coef.append(c)

    def tensor(v):
        return torch.tensor(v, dtype=I64, device=device)

    return tensor(dst), tensor(src), tensor(coef)


def solinas_reduce(cols, fs: FieldSpec, col_bound: int = 1 << 22):
    """Reduce redundant product columns (ncols, *batch) mod p to [0, p).

    cols[k] in [0, col_bound); the combined + offset value is normalized and
    folded three times (bounds proven in _plan; the third fold's carry is 0
    because c3 = 1 implies w3 < cbar), then one conditional subtract."""
    d = fs.ndigits
    ncols = cols.shape[0]
    _, offset_digits, c1_max = _plan(fs, ncols, col_bound)
    assert c1_max * ((1 << fs.nbits) % fs.p) < (1 << fs.nbits)

    dst, src, coef = _combine_terms(fs, ncols, cols.device)
    coef = coef.reshape((-1,) + (1,) * (cols.dim() - 1))
    combined = cols[:d] + mont._const_planes(offset_digits[:d], cols)
    combined = combined.index_add(0, dst, cols[src] * coef)

    w, c = bn.normalize_signed(combined)
    c = c + offset_digits[d]  # the offset may have d+1 digits

    cbar = [0] * d
    for pos, coeff in _cbar_digit_terms(fs):
        cbar[pos] = coeff
    cbar = mont._const_planes(cbar, cols)  # signed entries; int64 holds them

    for _ in range(3):
        w, c = bn.normalize_signed(w + cbar * c.unsqueeze(0))
    return mont._cond_sub_p(w, c, fs)


def fast_mul(a, b, fs: FieldSpec, scale: int = 1):
    """scale*a*b mod p (plain domain) via the product grid + Solinas
    reduction. ``scale`` (a small positive constant, <= 8) multiplies the
    redundant columns before the reduction, whose interval proof re-runs
    with the scaled bound."""
    cols = mont._product_columns(a, b)
    if scale != 1:
        cols = cols * scale
    return solinas_reduce(cols, fs, col_bound=scale << 22)


def fast_sqr(a, fs: FieldSpec, scale: int = 1):
    """scale*a^2 mod p. The JAX package shares the symmetric products of a
    triangular grid; eager PyTorch pays per operation launched rather than
    per digit product, so the full grid (fewer, wider operations) is used."""
    return fast_mul(a, a, fs, scale)
