"""Python-int co-Z Jacobian group law + constant-time ladder (the algorithm contract).

Co-Z arithmetic after Goundar-Joye-Miyaji, eprint 2010/309 (the same source the
reference cites at ``curve_group.h:61-62``), with the force-odd parity trick from
Joye CHES 2007 used by the reference ladder (``curve_group.h:189-218``,
``work/coz_swap.py:214-251``).

Points are Jacobian triples (X, Y, Z) of classical (non-Montgomery) residues:
affine coordinates are (X/Z^2, Y/Z^3). All functions operate mod curve.p with
Python ints. These define the exact group-law outputs the batched TPU kernels
must reproduce (after Montgomery-domain conversion).
"""

from __future__ import annotations

from ecsimd_tpu_torch.specs import CurveSpec

Jac = tuple[int, int, int]


def jacobian_from_affine(x: int, y: int) -> Jac:
    return (x, y, 1)


def jacobian_to_affine(pt: Jac, curve: CurveSpec) -> tuple[int, int]:
    """(X/Z^2, Y/Z^3); reference jacobian_curve_point.h:33-42."""
    p = curve.p
    x, y, z = pt
    if z % p == 0:
        raise ZeroDivisionError("point at infinity has no affine form")
    zi = pow(z, -1, p)
    zi2 = zi * zi % p
    return (x * zi2 % p, y * zi2 % p * zi % p)


def point_opposite(pt: Jac, curve: CurveSpec) -> Jac:
    """-(X, Y, Z) = (X, -Y, Z); reference jacobian_curve_point.h:48-54."""
    x, y, z = pt
    return (x, (-y) % curve.p, z)


def dblu(pt: Jac, curve: CurveSpec) -> tuple[Jac, Jac]:
    """Initial doubling with co-Z update (DBLU); requires Z == 1.

    Returns (2P, P') where P' is P re-represented with the same Z as 2P.
    Reference curve_group.h:64-87.
    """
    p = curve.p
    x1, y1, z1 = pt
    assert z1 % p == 1
    b = x1 * x1 % p
    e = y1 * y1 % p
    l = e * e % p
    s = 2 * ((x1 + e) * (x1 + e) % p - b - l) % p
    m = (3 * b + curve.a) % p
    x3 = (m * m - 2 * s) % p
    l8 = 8 * l % p
    y3 = (m * (s - x3) - l8) % p
    z3 = 2 * y1 % p
    return (x3, y3, z3), (s % p, l8, z3)


def zaddu(pt1: Jac, pt2: Jac, curve: CurveSpec) -> tuple[Jac, Jac]:
    """Co-Z addition with update (ZADDU): returns (P+Q, P') sharing one Z.

    Requires Z1 == Z2. Reference curve_group.h:91-116.
    """
    p = curve.p
    x1, y1, z = pt1
    x2, y2, z2 = pt2
    assert z % p == z2 % p
    c = (x1 - x2) * (x1 - x2) % p
    w1 = x1 * c % p
    w2 = x2 * c % p
    d = (y1 - y2) * (y1 - y2) % p
    a1 = y1 * (w1 - w2) % p
    x3 = (d - w1 - w2) % p
    y3 = ((y1 - y2) * (w1 - x3) - a1) % p
    z3 = z * (x1 - x2) % p
    return (x3, y3, z3), (w1, a1, z3)


def zdau(pt1: Jac, pt2: Jac, curve: CurveSpec) -> tuple[Jac, Jac]:
    """Co-Z double-add with update (ZDAU): returns (2P+Q, Q') sharing one Z.

    Requires Z1 == Z2. Reference curve_group.h:120-153.
    """
    p = curve.p
    x1, y1, z = pt1
    x2, y2, z2 = pt2
    assert z % p == z2 % p
    cp = (x1 - x2) * (x1 - x2) % p
    w1p = x1 * cp % p
    w2p = x2 * cp % p
    dp = (y1 - y2) * (y1 - y2) % p
    a1p = y1 * (w1p - w2p) % p
    x3pc = (dp - w1p - w2p) % p
    c = (x3pc - w1p) * (x3pc - w1p) % p
    y3p = (((y1 - y2) + (w1p - x3pc)) ** 2 - dp - c - 2 * a1p) % p
    w1 = 4 * x3pc * c % p
    w2 = 4 * w1p * c % p
    d = (y3p - 2 * a1p) * (y3p - 2 * a1p) % p
    a1 = y3p * (w1 - w2) % p
    x3 = (d - w1 - w2) % p
    y3 = ((y3p - 2 * a1p) * (w1 - x3) - a1) % p
    z3 = z * ((x1 - x2 + x3pc - w1p) ** 2 - cp - c) % p
    dc = (y3p + 2 * a1p) * (y3p + 2 * a1p) % p
    x2n = (dc - w1 - w2) % p
    y2n = ((y3p + 2 * a1p) * (w1 - x2n) - a1) % p
    return (x3, y3, z3), (x2n, y2n, z3)


def add_z2_1(pt1: Jac, pt2: Jac, curve: CurveSpec) -> Jac:
    """Mixed Jacobian+affine-style addition requiring Z2 == 1.

    Reference curve_group.h:155-179 (used for the even-scalar parity fixup).
    """
    p = curve.p
    x1, y1, z1 = pt1
    x2, y2, z2 = pt2
    assert z2 % p == 1
    z1z1 = z1 * z1 % p
    u2 = x2 * z1z1 % p
    s2 = y2 * z1 % p * z1z1 % p
    h = (u2 - x1) % p
    hh = h * h % p
    i = 4 * hh % p
    j = h * i % p
    r = 2 * (s2 - y1) % p
    v = x1 * i % p
    x3 = (r * r - j - 2 * v) % p
    y3 = (r * (v - x3) - 2 * y1 * j) % p
    z3 = ((z1 + h) * (z1 + h) - z1z1 - hh) % p
    return (x3, y3, z3)


def tplu(pt: Jac, curve: CurveSpec) -> tuple[Jac, Jac]:
    """Co-Z tripling: returns (3P, P') sharing one Z. Reference curve_group.h:183-186."""
    dbl, upd = dblu(pt, curve)
    return zaddu(upd, dbl, curve)


def scalar_mult(k: int, pt: Jac, curve: CurveSpec) -> Jac:
    """Constant-time-shaped co-Z signed ladder computing k*P, k in [1, order).

    Matches the reference's lane algorithm exactly (curve_group.h:189-218):
    force k odd (compute (k|1)*P over bits 1..nbits-1, LSB->MSB after the
    initial TRPLU seeds bit 1), then subtract P once if k was even. The swap
    pattern per bit is what the batched kernel realizes with per-lane masks.

    Unsupported scalars (same exclusion set as the reference): k = 0 mod order
    and scalars whose ladder hits a co-Z degeneracy (X1 == X2); for k uniform
    in [1, order) these do not occur for the generator.
    """
    nbits = curve.field.nbits
    opp = point_opposite(pt, curve)
    base, acc = tplu(pt, curve)  # base = 3P, acc = P (co-Z)
    if (k >> 1) & 1:
        acc, base = base, acc
    for i in range(2, nbits):
        bit = (k >> i) & 1
        if bit:
            acc, base = base, acc
        base, acc = zdau(base, acc, curve)
        if bit:
            acc, base = base, acc
    if k & 1 == 0:
        acc = add_z2_1(acc, opp, curve)
    return acc


def scalar_mult_affine(k: int, x: int, y: int, curve: CurveSpec) -> tuple[int, int]:
    return jacobian_to_affine(scalar_mult(k, jacobian_from_affine(x, y), curve), curve)


def naive_scalar_mult(k: int, x: int, y: int, curve: CurveSpec) -> tuple[int, int] | None:
    """Independent textbook affine double-and-add, as a second opinion on the
    co-Z ladder (plays the role PyCryptodome plays in work/coz.py:235-267)."""
    p = curve.p

    def add(P, Q):
        if P is None:
            return Q
        if Q is None:
            return P
        (x1, y1), (x2, y2) = P, Q
        if x1 == x2 and (y1 + y2) % p == 0:
            return None
        if P == Q:
            lam = (3 * x1 * x1 + curve.a) * pow(2 * y1, -1, p) % p
        else:
            lam = (y2 - y1) * pow(x2 - x1, -1, p) % p
        x3 = (lam * lam - x1 - x2) % p
        return (x3, (lam * (x1 - x3) - y1) % p)

    result, addend = None, (x, y)
    while k:
        if k & 1:
            result = add(result, addend)
        addend = add(addend, addend)
        k >>= 1
    return result
