"""L5: co-Z Jacobian group law and the plain masked-swap ladder.

The port of ``ecsimd_tpu/curves/group.py`` (co-Z arithmetic after
Goundar-Joye-Miyaji, eprint 2010/309). ``scalar_mult`` here is the plain
PyTorch version of the ladder kernel (``kernels/ladder.py``): the same
formula sequence on GFp planes, one Python loop over the scalar bits, every
step branch-free with per-lane swap masks. Since every field result is
canonical in [0, p), the kernel and this version give the same Jacobian
planes bit for bit.
"""

from __future__ import annotations

from ecsimd_tpu.specs import DIGIT_BITS, CurveSpec
from ecsimd_tpu_torch.curves.point import JacobianPoint
from ecsimd_tpu_torch.field import GFp, gfp_swap_if


# --- co-Z primitive steps ------------------------------------------------------
# Each returns coordinate GFp's; the two output points share one Z.


def dblu(x1: GFp, y1: GFp, curve: CurveSpec):
    """Initial co-Z doubling, Z == 1 assumed.

    Returns (x2p, y2p, xu, yu, z): 2P and re-represented P with common z.
    """
    am = x1.const_like(curve.a)
    b = x1.sqr()
    e = y1.sqr()
    l = e.sqr()
    s = ((x1 + e).sqr() - b - l).double()
    m = b.double() + b + am
    x2p = m.sqr() - s.double()
    l8 = l.shift_left(3)
    y2p = m * (s - x2p) - l8
    z = y1.double()
    return x2p, y2p, s, l8, z


def zaddu(x1: GFp, y1: GFp, x2: GFp, y2: GFp, z: GFp):
    """Co-Z addition with update: (P, Q) with common z -> (P+Q, P') with
    common z3. Returns (x3, y3, xu, yu, z3)."""
    c = (x1 - x2).sqr()
    w1 = x1 * c
    w2 = x2 * c
    d = (y1 - y2).sqr()
    a1 = y1 * (w1 - w2)
    x3 = d - w1 - w2
    y3 = (y1 - y2) * (w1 - x3) - a1
    z3 = z * (x1 - x2)
    return x3, y3, w1, a1, z3


def zdau(x1: GFp, y1: GFp, x2: GFp, y2: GFp, z: GFp):
    """Co-Z double-add with update: (P, Q) with common z -> (2P+Q, Q') with
    common z3. Returns (x3, y3, xq, yq, z3) — the ladder's per-bit step."""
    cp = (x1 - x2).sqr()
    w1p = x1 * cp
    w2p = x2 * cp
    dp = (y1 - y2).sqr()
    a1p = y1 * (w1p - w2p)
    x3pc = dp - w1p - w2p
    c = (x3pc - w1p).sqr()
    a1p2 = a1p.double()
    y3p = ((y1 - y2) + (w1p - x3pc)).sqr() - dp - c - a1p2
    w1 = x3pc.mul_scaled(c, 4)
    w2 = w1p.mul_scaled(c, 4)
    t_minus = y3p - a1p2
    d = t_minus.sqr()
    a1 = y3p * (w1 - w2)
    x3 = d - w1 - w2
    y3 = t_minus * (w1 - x3) - a1
    z3 = z * ((x1 - x2 + x3pc - w1p).sqr() - cp - c)
    t_plus = y3p + a1p2
    dc = t_plus.sqr()
    xq = dc - w1 - w2
    yq = t_plus * (w1 - xq) - a1
    return x3, y3, xq, yq, z3


def add_z2_1(x1: GFp, y1: GFp, z1: GFp, x2: GFp, y2: GFp):
    """Mixed add with Z2 == 1. Returns (x3, y3, z3)."""
    z1z1 = z1.sqr()
    u2 = x2 * z1z1
    s2 = y2 * z1 * z1z1
    h = u2 - x1
    hh = h.sqr()
    j = h.mul_scaled(hh, 4)
    r = (s2 - y1).double()
    v = x1.mul_scaled(hh, 4)
    x3 = r.sqr() - j - v.double()
    y3 = r * (v - x3) - y1.mul_scaled(j, 2)
    z3 = (z1 + h).sqr() - z1z1 - hh
    return x3, y3, z3


def tplu(x1: GFp, y1: GFp, curve: CurveSpec):
    """Co-Z tripling: (3P, P') with common z."""
    x2p, y2p, xu, yu, z = dblu(x1, y1, curve)
    return zaddu(xu, yu, x2p, y2p, z)


# --- the ladder -------------------------------------------------------------------


def _bit_at(scalars, i: int):
    """Per-lane 0/1 mask = bit i of each lane's scalar (digits are
    nonnegative, so the arithmetic shift is the logical one)."""
    digit, off = divmod(i, DIGIT_BITS)
    return (scalars[digit] >> off) & 1


def scalar_mult(scalars, pt: JacobianPoint) -> JacobianPoint:
    """Batched constant-time scalar multiplication k_i * P_i per lane.

    scalars: (D, *batch) classical digit planes; pt: Jacobian batch with
    z = 1 (from_affine). Force-odd co-Z signed ladder: seed with TPLU,
    consume bits 1..nbits-1 LSB -> MSB with masked co-Z swaps around each
    ZDAU, then subtract P via ADD_Z2_1 on even lanes.

    Domain: k in [1, order-1). k = order-1 is even, so the parity fixup
    computes order*P = infinity and the lane degenerates (z = 0)."""
    curve = pt.curve
    nbits = curve.field.nbits

    opp_y = pt.y.opposite()
    bx, by, ax, ay, z = tplu(pt.x, pt.y, curve)  # base = 3P, acc = P

    m1 = _bit_at(scalars, 1)
    ax, bx = gfp_swap_if(m1, ax, bx)
    ay, by = gfp_swap_if(m1, ay, by)

    for i in range(2, nbits):
        m = _bit_at(scalars, i)
        ax, bx = gfp_swap_if(m, ax, bx)
        ay, by = gfp_swap_if(m, ay, by)
        bx, by, ax, ay, z = zdau(bx, by, ax, ay, z)
        ax, bx = gfp_swap_if(m, ax, bx)
        ay, by = gfp_swap_if(m, ay, by)

    # parity fixup: even scalars got (k+1)P in acc; subtract P
    sx, sy, sz = add_z2_1(ax, ay, z, pt.x, opp_y)
    meven = 1 - _bit_at(scalars, 0)
    acc = JacobianPoint(ax, ay, z, curve)
    sub = JacobianPoint(sx, sy, sz, curve)
    return sub.select(meven, acc)
