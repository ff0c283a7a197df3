"""Python-int Montgomery field model (the bit-exactness contract).

The port's own copy of ``ecsimd_tpu/oracle/field.py`` (the CIOS tests, the
recovery oracle and ``glv_params`` call it); ``tests/test_torch_specs.py``
holds it to the original.

Montgomery domain with radix R = 2^nbits, identical to the reference
(``mgry.h:18-26``, ``mgry_csts.h:15``): a residue x is stored as x*R mod p.
Each function defines the exact value every TPU kernel must reproduce.
"""

from __future__ import annotations

from ecsimd_tpu_torch.specs import FieldSpec


def mont_from_classical(x: int, fs: FieldSpec) -> int:
    """classical -> Montgomery: x*R mod p (reference mgry.h:47-50)."""
    return (x << fs.nbits) % fs.p


def mont_to_classical(xm: int, fs: FieldSpec) -> int:
    """Montgomery -> classical: x*R^-1 mod p (reference mgry.h:52-55)."""
    return (xm * fs.R_inv) % fs.p


def mont_reduce(t: int, fs: FieldSpec) -> int:
    """REDC of a 2N-digit value: t*R^-1 mod p, result in [0, p).

    Contract for the digit-level CIOS kernel (reference mgry_mul.h:84-121).
    """
    assert 0 <= t < fs.R * fs.p
    return (t * fs.R_inv) % fs.p


def mont_mul(am: int, bm: int, fs: FieldSpec) -> int:
    """Montgomery product a*b*R^-1 mod p (reference mgry_ops.h:31-35)."""
    return (am * bm * fs.R_inv) % fs.p


def mont_sqr(am: int, fs: FieldSpec) -> int:
    return mont_mul(am, am, fs)


def mont_add(am: int, bm: int, fs: FieldSpec) -> int:
    return (am + bm) % fs.p


def mont_sub(am: int, bm: int, fs: FieldSpec) -> int:
    return (am - bm) % fs.p


def mont_opposite(am: int, fs: FieldSpec) -> int:
    """Negation; reference implements it via the (p-1)*R trick (gfp.h:60-64)."""
    return (-am) % fs.p


def mont_pow(am: int, e: int, fs: FieldSpec) -> int:
    """Montgomery-domain power with *classical* exponent: returns (a^e)*R mod p.

    Matches mgry_pow (reference mgry_ops.h:44-86): result is in Montgomery
    domain such that to_classical(result) == a^e mod p.
    """
    a = mont_to_classical(am, fs)
    return mont_from_classical(pow(a, e, fs.p), fs)


def mont_inverse(am: int, fs: FieldSpec) -> int:
    """Fermat inversion x^(p-2) (reference gfp.h:42-44)."""
    return mont_pow(am, fs.fermat_exponent, fs)


def mont_sqrt(am: int, fs: FieldSpec) -> int | None:
    """Square root or None for non-residues (reference gfp.h:46-54 covers
    only p = 3 mod 4; this oracle mirrors field.GFp.sqrt's full dispatch,
    verified by squaring back)."""
    kind = fs.sqrt_kind
    if kind == "p3mod4":
        r = mont_pow(am, fs.sqrt_exponent, fs)
    elif kind == "p5mod8":
        r = mont_pow(am, (fs.p + 3) // 8, fs)
        if mont_mul(r, r, fs) != am % fs.p:
            r = mont_mul(r, mont_from_classical(fs.sqrt_m1, fs), fs)
    else:
        q, s, c = fs.ts_params
        x = mont_to_classical(am, fs)
        p = fs.p
        t, r = pow(x, q, p), pow(x, (q + 1) // 2, p)
        for i in range(s, 1, -1):
            b = t
            for _ in range(i - 2):
                b = b * b % p
            if b != 1:
                r = r * c % p
            c = c * c % p
            if b != 1:
                t = t * c % p
        r = mont_from_classical(r, fs)
    if mont_mul(r, r, fs) != am % fs.p:
        return None
    return r
