"""GLV double-scalar signed window k_i * P_i: kernel F (``csrc/glv.cu``), its
wrapper, the scalar packing, the plain PyTorch version, and the strict
variable-base router.

Replaces ``ecsimd_tpu/kernels/glv.py`` (``glv_mont_planes`` and its Pallas
body ``_glv_kernel``, both ``strict`` variants; ``glv_plain`` is the
counterpart of ``_glv_core`` / ``glv_xla_planes``). On a j-invariant-0 curve
(secp256k1) k P = s1 |k1| P + s2 |k2| phi(P) with phi(x, y, z) = (beta x, y,
z) and ~128-bit halves from ``glv.split_planes``: one shared run of
doublings feeds two recoded streams, and the second table is the first with
x scaled by beta. The chain works on Montgomery-form planes, as the JAX
package's; every field result is canonical, so the kernel's Jacobian planes
equal ``glv_plain``'s bit for bit.

Scalar domain: strict (the default) all of [1, order) — k = lambda gives
k1 = 0 and lambda +- 1 make the chain hit a table entry, which the complete
adds resolve; plain only for trusted uniform scalars, off the degenerate
classes.

``strict_varbase`` is the port of ``ecsimd_tpu/kernels/glv.py:
strict_varbase``: GLV-capable curves go to the strict GLV chain (kernel F on
the card), every other curve to the strict window (kernel E).
"""

from __future__ import annotations

import functools

import torch

from ecsimd_tpu_torch import glv
from ecsimd_tpu_torch.curves import group
from ecsimd_tpu_torch.curves.point import AffinePoint, JacobianPoint
from ecsimd_tpu_torch.field import GFp
from ecsimd_tpu_torch.kernels import _build, window
from ecsimd_tpu_torch.specs import DIGIT_BITS, SECP256K1, CurveSpec, int_to_digits

W = 4  # window width in bits
TABLE = 1 << (W - 1)  # odd multiples P, 3P, .., 15P
KERNEL_DIGITS = 9  # glv_params(SECP256K1).dk, a constant of csrc/glv.cu

KERNEL = _build.Kernel(
    symbol="ec_glv_secp256k1",
    source="ecsimd_tpu_torch/csrc/glv.cu",
    replaces="ecsimd_tpu/kernels/glv.py:175 _glv_kernel",
    n_pointers=7,
)
KERNEL_STRICT = _build.Kernel(
    symbol="ec_glv_secp256k1_strict",
    source="ecsimd_tpu_torch/csrc/glv.cu",
    replaces="ecsimd_tpu/kernels/glv.py:175 _glv_kernel (strict=True)",
    n_pointers=7,
)


def pack_scalars(scalars, curve: CurveSpec):
    """(D, B) classical scalar planes -> (2dk + 2, B) int32 packed rows:
    |k1| digits, |k2| digits, sign of k1, sign of k2."""
    k1, k2, n1, n2 = glv.split_planes(scalars, curve)
    return torch.cat([k1, k2, n1.unsqueeze(0), n2.unsqueeze(0)]).to(torch.int32)


def _recode(plane, plane_next, off: int):
    """Signed-odd digit of the 4-bit window at bit ``off`` of a 16-bit digit
    plane (``plane_next`` the digit above): (table index, neg mask)."""
    w5 = plane >> off
    if off:
        w5 = w5 | (plane_next << (DIGIT_BITS - off))
    sd = ((w5 & 31) | 1) - 16  # odd, in [-15, 15]
    neg = (sd < 0).to(torch.int64)
    return (torch.where(neg.bool(), -sd, sd) - 1) >> 1, neg


def _lookup(xs, ys, zs, idx, neg):
    """Masked 8-way table read (every entry is read) and masked y negation."""
    tx, ty, tz = xs[TABLE - 1], ys[TABLE - 1], zs[TABLE - 1]
    for t in range(TABLE - 2, -1, -1):
        m = (idx == t).to(torch.int64)
        tx, ty, tz = xs[t].select(m, tx), ys[t].select(m, ty), zs[t].select(m, tz)
    return tx, ty.opposite().select(neg, ty), tz


def glv_plain(packed, xm, ym, curve: CurveSpec, strict: bool = True):
    """Plain PyTorch GLV chain on ``pack_scalars`` rows and Montgomery-form
    affine planes (z = 1), in the order of ``ecsimd_tpu/kernels/glv.py:
    _glv_core``. Returns Jacobian (ax, ay, z) int32 planes in Montgomery form."""
    fs = curve.field
    dk = glv.glv_params(curve).dk
    rows = packed.to(torch.int64)
    x, y = GFp(xm, fs), GFp(ym, fs)
    one = x.const_like(1)
    beta = x.const_like(glv.glv_params(curve).beta)
    opp_y = y.opposite()
    neg1, neg2 = rows[2 * dk] & 1, rows[2 * dk + 1] & 1

    two = group.dbl_any(x, y, one, curve)
    table = [(x, y, one)]
    for _ in range(TABLE - 1):
        table.append(group.jac_add(*table[-1], *two))
    xs1 = [tx for tx, _, _ in table]
    ys = [ty for _, ty, _ in table]
    zs = [tz for _, _, tz in table]
    xs2 = [beta * tx for tx in xs1]
    x2 = xs2[0]

    def adder(*args):
        if strict:
            return group.add_complete(*args, curve)
        return group.jac_add(*args)

    ax, ay, az = adder(x, y.select(1 - neg1, opp_y), one, x2, y.select(1 - neg2, opp_y), one)
    zero = torch.zeros_like(rows[0])
    for dig in range(dk - 1, -1, -1):
        p1, p2 = rows[dig], rows[dk + dig]
        p1n = rows[dig + 1] if dig + 1 < dk else zero
        p2n = rows[dk + dig + 1] if dig + 1 < dk else zero
        for off in range(DIGIT_BITS - W, -1, -W):  # 12, 8, 4, 0
            i1, s1 = _recode(p1, p1n, off)
            i2, s2 = _recode(p2, p2n, off)
            for _ in range(W):
                ax, ay, az = group.dbl_any(ax, ay, az, curve)
            ax, ay, az = adder(ax, ay, az, *_lookup(xs1, ys, zs, i1, s1 ^ neg1))
            ax, ay, az = adder(ax, ay, az, *_lookup(xs2, ys, zs, i2, s2 ^ neg2))

    # parity fix-ups: an even |k_i| was computed as |k_i| + 1; add -s_i base_i
    for bx, row, negm in ((x, 0, neg1), (x2, dk, neg2)):
        fy = y.select(negm, opp_y)
        if strict:
            sx, sy, sz = group.add_complete(ax, ay, az, bx, fy, one, curve)
        else:
            sx, sy, sz = group.add_z2_1(ax, ay, az, bx, fy)
        meven = 1 - (rows[row] & 1)
        ax, ay, az = sx.select(meven, ax), sy.select(meven, ay), sz.select(meven, az)
    return ax.planes, ay.planes, az.planes


@functools.cache
def _beta_digits(curve: CurveSpec, device: torch.device):
    """beta's 16 Montgomery-form digits as an int32 tensor, as kernel F
    reads them."""
    fs = curve.field
    beta_m = (glv.glv_params(curve).beta << fs.nbits) % fs.p
    return torch.tensor(int_to_digits(beta_m, fs.ndigits), dtype=torch.int32, device=device)


def glv_planes(packed, xm, ym, curve: CurveSpec = SECP256K1, strict: bool = True):
    """Run kernel F on CUDA tensors: ``pack_scalars`` rows and (D, B) int32
    Montgomery-form affine planes. Returns Jacobian (ax, ay, z) planes."""
    _build.require_cuda(packed, "glv")
    if curve != SECP256K1:
        raise NotImplementedError(
            f"{curve.name}: the CUDA GLV kernel covers secp256k1 only, the one GLV curve shipped"
        )
    assert glv.glv_params(curve).dk == KERNEL_DIGITS
    d = curve.field.ndigits
    b = packed.shape[-1]
    dev = packed.device
    _build.check_planes("packed", packed, (2 * KERNEL_DIGITS + 2, b), dev)
    for name, t in (("x", xm), ("y", ym)):
        _build.check_planes(name, t, (d, b), dev)
    kernel = KERNEL_STRICT if strict else KERNEL
    ax, ay, z = (torch.empty((d, b), dtype=torch.int32, device=dev) for _ in range(3))
    _build.launch(kernel, [packed, xm, ym, _beta_digits(curve, dev), ax, ay, z], b)
    kernel.count(b)
    return ax, ay, z


def scalar_mult(scalars, pt: AffinePoint, strict: bool = True) -> JacobianPoint:
    """k_i * P_i on a GLV-capable curve: the split (plain PyTorch, on the
    tensors' device), then kernel F for CUDA tensors or ``glv_plain`` for
    CPU tensors. Returns Jacobian planes in Montgomery form."""
    curve = pt.curve
    fs = curve.field
    packed = pack_scalars(scalars, curve)
    xm = GFp.from_classical(pt.x, fs).planes.contiguous()
    ym = GFp.from_classical(pt.y, fs).planes.contiguous()
    if scalars.device.type == "cpu":
        ax, ay, z = glv_plain(packed, xm, ym, curve, strict)
    else:
        ax, ay, z = glv_planes(packed.contiguous(), xm, ym, curve, strict)
    return JacobianPoint(GFp(ax, fs), GFp(ay, fs), GFp(z, fs), curve)


def strict_varbase(scalars, pt: AffinePoint) -> JacobianPoint:
    """k_i * P_i over the whole scalar domain [1, order): the strict GLV
    chain on GLV-capable curves, the strict window otherwise."""
    if glv.glv_capable(pt.curve):
        return scalar_mult(scalars, pt, strict=True)
    return window.scalar_mult(scalars, pt, strict=True)
