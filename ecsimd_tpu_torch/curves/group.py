"""L5: co-Z Jacobian group law and the plain masked-swap ladder.

The port of ``ecsimd_tpu/curves/group.py`` (co-Z arithmetic after
Goundar-Joye-Miyaji, eprint 2010/309, point decompression), plus plain twins
of the free-standing Jacobian formulas of ``ecsimd_tpu/kernels/coz.py`` that
the window, GLV and comb kernels run (``dbl_am3``, ``jac_dbl``,
``jac_add``, ``aff_add``, ``add_complete`` and the ``*_any`` dispatch over
the curve's shape). ``scalar_mult`` here is the plain
PyTorch version of the ladder kernel (``kernels/ladder.py``): the same
formula sequence on GFp planes, one Python loop over the scalar bits, every
step branch-free with per-lane swap masks. Since every field result is
canonical in [0, p), the kernel and this version give the same Jacobian
planes bit for bit. ``batch_sum``, the sum of a batch by the JAX package's
tree of ``jac_add_complete``, is the plain version of kernel M
(``kernels/batch_sum.py``).
"""

from __future__ import annotations

import torch

from ecsimd_tpu_torch.specs import DIGIT_BITS, CurveSpec
from ecsimd_tpu_torch.curves.point import AffinePoint, JacobianPoint
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


# --- free-standing Jacobian doubling and adds -----------------------------------


def jac_dbl(x1: GFp, y1: GFp, z1: GFp, curve: CurveSpec):
    """General-a Jacobian doubling (dbl-2007-bl shape), the port of
    ``ecsimd_tpu/curves/group.py:jac_dbl`` and of ``kernels/coz.py:
    jac_dbl_general_a``, which drops the a term for a = 0 (1M + 7S there,
    as in ``csrc/coz_secp256k1.cuh``; the values are the same). Doubling of
    infinity stays at infinity (z3 = 2 y1 z1)."""
    xx = x1.sqr()
    yy = y1.sqr()
    yyyy = yy.sqr()
    zz = z1.sqr()
    s = ((x1 + yy).sqr() - xx - yyyy).double()
    m = xx + xx.double()
    if curve.a % curve.p:
        m = m + x1.const_like(curve.a) * zz.sqr()
    x3 = m.sqr() - s.double()
    y3 = m * (s - x3) - yyyy.shift_left(3)
    z3 = (y1 + z1).sqr() - yy - zz
    return x3, y3, z3


def jac_add_complete(p1: JacobianPoint, p2: JacobianPoint) -> JacobianPoint:
    """Exception-free general Jacobian add (add-2007-bl with masked
    completion), the port of ``ecsimd_tpu/curves/group.py:jac_add_complete``:

      h == 0, r == 0  (P1 == P2)   -> doubling of P1 (``jac_dbl``),
      h == 0, r != 0  (P1 == -P2)  -> infinity (Z == 0),
      Z1 == 0         (P1 == inf)  -> P2,
      Z2 == 0         (P2 == inf)  -> P1,

    with per-lane selects only. The strict comb's plain version."""
    curve = p1.curve
    x1, y1, z1 = p1.x, p1.y, p1.z
    x2, y2, z2 = p2.x, p2.y, p2.z
    x3, y3, z3, h, r = jac_add(x1, y1, z1, x2, y2, z2, with_hr=True)
    hz, rz = h.is_zero(), r.is_zero()
    inf1, inf2 = z1.is_zero(), z2.is_zero()
    m_same = hz & rz & (1 - inf1) & (1 - inf2)
    m_opp = hz & (1 - rz) & (1 - inf1) & (1 - inf2)
    xd, yd, zd = jac_dbl(x1, y1, z1, curve)
    x3 = xd.select(m_same, x3)
    y3 = yd.select(m_same, y3)
    z3 = zd.select(m_same, z3.select(1 - m_opp, z3.const_like(0)))
    x3 = x2.select(inf1, x1.select(inf2, x3))
    y3 = y2.select(inf1, y1.select(inf2, y3))
    z3 = z2.select(inf1, z1.select(inf2, z3))
    return JacobianPoint(x3, y3, z3, curve)


# --- plain twins of the kernels' device formulas --------------------------------
# ``ecsimd_tpu/kernels/coz.py``'s jac_dbl, jac_add, add_complete_any and the
# dispatch over the curve's shape, as ``csrc/coz_p256.cuh`` (a = -3) and
# ``csrc/coz_secp256k1.cuh`` (a = 0) run them.


def _require_am3(curve: CurveSpec):
    if not curve.am3:
        raise NotImplementedError(
            f"{curve.name}: dbl-2001-b needs a = -3; curves with another a double "
            "through jac_dbl (dbl_any dispatches, ROADMAP B0)"
        )


def dbl_am3(x1: GFp, y1: GFp, z1: GFp, curve: CurveSpec):
    """dbl-2001-b for a = -3 (3M + 5S), the twin of
    ``ecsimd_tpu/kernels/coz.py:jac_dbl`` and of ``jac_dbl`` in
    ``csrc/coz_p256.cuh``. For a = -3 it gives the same values as the
    general-a ``jac_dbl``: X3 = M^2 - 8XY^2, Z3 = 2YZ with M = 3(X - Z^2)(X + Z^2)."""
    _require_am3(curve)
    delta = z1.sqr()
    gamma = y1.sqr()
    beta4 = x1.mul_scaled(gamma, 4)
    alpha = (x1 - delta).mul_scaled(x1 + delta, 3)
    x3 = alpha.sqr() - beta4.double()
    z3 = (y1 + z1).sqr() - gamma - delta
    y3 = alpha * (beta4 - x3) - gamma.sqr().shift_left(3)
    return x3, y3, z3


def dbl_any(x1: GFp, y1: GFp, z1: GFp, curve: CurveSpec):
    """``kernels/coz.py:dbl_any``: dbl-2001-b for a = -3, the general-a
    doubling otherwise."""
    if curve.am3:
        return dbl_am3(x1, y1, z1, curve)
    return jac_dbl(x1, y1, z1, curve)


def jac_add(x1: GFp, y1: GFp, z1: GFp, x2: GFp, y2: GFp, z2: GFp, with_hr: bool = False):
    """General Jacobian add (add-2007-bl with Z3 = Z1 Z2 H, 12M + 4S); degenerate when the x
    lines collide (h == 0). ``with_hr`` also returns (h, r) for the complete
    add. Twin of ``ecsimd_tpu/kernels/coz.py:jac_add``."""
    z1z1 = z1.sqr()
    z2z2 = z2.sqr()
    u1 = x1 * z2z2
    u2 = x2 * z1z1
    s1 = y1 * z2z2 * z2
    s2 = y2 * z1z1 * z1
    h = u2 - u1
    r = s2 - s1
    hh = h.sqr()
    hhh = h * hh
    v = u1 * hh
    x3 = r.sqr() - hhh - v.double()
    y3 = r * (v - x3) - s1 * hhh
    z3 = z1 * z2 * h
    if with_hr:
        return x3, y3, z3, h, r
    return x3, y3, z3


def aff_add(x1: GFp, y1: GFp, x2: GFp, y2: GFp):
    """Affine + affine -> Jacobian (the z1 = z2 = 1 add, 4M + 2S), the twin of
    ``ecsimd_tpu/kernels/coz.py:aff_add_fused`` / ``aff_add_generic`` and of
    ``aff_add`` in ``csrc/jacobian.cuh``: H = x2 - x1, r = y2 - y1,
    X3 = r^2 - H^3 - 2 x1 H^2, Y3 = r (x1 H^2 - X3) - y1 H^3, Z3 = H.
    Degenerate when x1 == x2 (H = 0). The comb tree's first level."""
    h = x2 - x1
    r = y2 - y1
    hh = h.sqr()
    hhh = h * hh
    v = x1 * hh
    x3 = r.sqr() - hhh - v.double()
    y3 = r * (v - x3) - y1 * hhh
    return x3, y3, h


def add_complete(x1: GFp, y1: GFp, z1: GFp, x2: GFp, y2: GFp, z2: GFp, curve: CurveSpec):
    """Exception-free add of the strict window, GLV and comb kernels, the
    twin of ``ecsimd_tpu/kernels/coz.py:add_complete_any``: P1 == P2 ->
    ``dbl_any`` of P1, P1 == -P2 -> infinity (Z == 0), P1 == inf ->
    (x2, y2, 1). P2 must be finite. Per-lane selects only."""
    x3, y3, z3, h, r = jac_add(x1, y1, z1, x2, y2, z2, with_hr=True)
    hz, rz, inf1 = h.is_zero(), r.is_zero(), z1.is_zero()
    m_same = hz & rz & (1 - inf1)
    m_opp = hz & (1 - rz) & (1 - inf1)
    xd, yd, zd = dbl_any(x1, y1, z1, curve)
    x3 = xd.select(m_same, x3)
    y3 = yd.select(m_same, y3)
    z3 = zd.select(m_same, z3.select(1 - m_opp, z3.const_like(0)))
    x3 = x2.select(inf1, x3)
    y3 = y2.select(inf1, y3)
    z3 = x1.const_like(1).select(inf1, z3)
    return x3, y3, z3


# --- point decompression ---------------------------------------------------------


def compute_y(x: GFp, curve: CurveSpec):
    """Solve y^2 = x^3 + a x + b per lane: (y, ok mask)."""
    rhs = x.sqr() * x + x.const_like(curve.a) * x + x.const_like(curve.b)
    return rhs.sqrt()


def affine_from_x(x_planes, curve: CurveSpec):
    """Decompress a batch of classical x coordinates: (AffinePoint, ok mask);
    y is the root ``GFp.sqrt`` picks, its parity not chosen."""
    x = GFp.from_classical(x_planes, curve.field)
    y, ok = compute_y(x, curve)
    return AffinePoint(x_planes, y.to_classical(), curve), ok


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
    return _ladder(lambda i: _bit_at(scalars, i), pt)


def scalar_mult_shared(kbits, pt: JacobianPoint) -> JacobianPoint:
    """One shared scalar times a batch of points (the port of
    ``ecsimd_tpu/curves/group.py:scalar_mult_shared``): the ladder of
    ``scalar_mult`` with bit i of every lane's scalar taken from ``kbits``,
    an (nbits,) LSB-first 0/1 int tensor on the points' device, broadcast
    across the batch. Equal to ``scalar_mult`` on the planes of k mod
    2^nbits in every lane."""
    batch = pt.x.planes.shape[1:]
    return _ladder(lambda i: kbits[i].expand(batch), pt)


def _ladder(bit, pt: JacobianPoint) -> JacobianPoint:
    """The force-odd co-Z ladder of ``scalar_mult``, bit i of the lanes'
    scalars given by ``bit(i)`` (a per-lane 0/1 mask)."""
    curve = pt.curve
    nbits = curve.field.nbits

    opp_y = pt.y.opposite()
    bx, by, ax, ay, z = tplu(pt.x, pt.y, curve)  # base = 3P, acc = P

    m1 = bit(1)
    ax, bx = gfp_swap_if(m1, ax, bx)
    ay, by = gfp_swap_if(m1, ay, by)

    for i in range(2, nbits):
        m = bit(i)
        ax, bx = gfp_swap_if(m, ax, bx)
        ay, by = gfp_swap_if(m, ay, by)
        bx, by, ax, ay, z = zdau(bx, by, ax, ay, z)
        ax, bx = gfp_swap_if(m, ax, bx)
        ay, by = gfp_swap_if(m, ay, by)

    # parity fixup: even scalars got (k+1)P in acc; subtract P
    sx, sy, sz = add_z2_1(ax, ay, z, pt.x, opp_y)
    meven = 1 - bit(0)
    acc = JacobianPoint(ax, ay, z, curve)
    sub = JacobianPoint(sx, sy, sz, curve)
    return sub.select(meven, acc)


# --- batch reduction (multi-scalar multiplication epilogue) -----------------------


def batch_sum(pt: JacobianPoint) -> JacobianPoint:
    """Sum a flat (D, B) point batch into one point, returned as a 1-lane
    batch (the port of ``ecsimd_tpu/curves/group.py:batch_sum``): each
    level adds lane i to lane i + n // 2 with ``jac_add_complete`` and
    carries an odd last lane, ceil(log2 B) levels. Any lane, and the result,
    may be the point at infinity (z = 0). The tree fixes the output's
    Jacobian representative, so kernel M (``kernels/batch_sum.py``) keeps
    it. The plain version of kernel M."""
    curve = pt.curve
    fs = curve.field
    x, y, z = pt.x.planes, pt.y.planes, pt.z.planes
    assert x.ndim == 2, "batch_sum expects flat (D, B) planes"

    def jac(xp, yp, zp):
        return JacobianPoint(GFp.from_mont(xp, fs), GFp.from_mont(yp, fs),
                             GFp.from_mont(zp, fs), curve)

    while x.shape[1] > 1:
        n = x.shape[1]
        h = n // 2
        res = jac_add_complete(
            jac(x[:, :h], y[:, :h], z[:, :h]),
            jac(x[:, h:2 * h], y[:, h:2 * h], z[:, h:2 * h]),
        )
        x, y, z = res.x.planes, res.y.planes, res.z.planes
        if n % 2:
            x = torch.cat([x, pt.x.planes[:, n - 1:n]], dim=1)
            y = torch.cat([y, pt.y.planes[:, n - 1:n]], dim=1)
            z = torch.cat([z, pt.z.planes[:, n - 1:n]], dim=1)
        pt = jac(x, y, z)
    return jac(x, y, z)
