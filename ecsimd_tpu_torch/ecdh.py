"""Batched ECDH key agreement, the port of ``ecsimd_tpu/ecdh.py``.

* ``derive_public``: Q_i = d_i * G through the fixed-base comb (kernel B on
  the card).
* ``shared_secret``: S_i = d_i * Q_i with peer-key validation, through
  ``kernels/glv.strict_varbase``: the strict window (kernel E strict on the
  card), total on [1, n).

Validation (NIST SP 800-56A §5.6.2.3 partial public-key validation, batched
on the tensors' device as plain PyTorch): Q on the curve, Q not the all-zero
encoding of infinity, coordinates canonical (< p), and 1 <= d < n. Lanes
that fail are steered to the generator with scalar 1, so the kernel's
preconditions hold, and are reported by the mask; their outputs mean
nothing. For prime-order curves on-curve membership implies subgroup
membership; cofactor > 1 curves need an n*Q check the caller makes.

Masks are (B,) int32 0/1 tensors, as in the JAX package.
"""

from __future__ import annotations

import torch

from ecsimd_tpu_torch import convert
from ecsimd_tpu_torch.curves.point import AffinePoint
from ecsimd_tpu_torch.ecdsa import _on_curve, order_field
from ecsimd_tpu_torch.field import GFp
from ecsimd_tpu_torch.kernels import affine, comb
from ecsimd_tpu_torch.kernels import glv as kglv
from ecsimd_tpu_torch.ops import bignum as bn
from ecsimd_tpu_torch.ops import mont
from ecsimd_tpu_torch.specs import P256, CurveSpec

I64 = torch.int64


def _scalar_ok(ds, curve: CurveSpec):
    """1 <= d < n, lane-wise (int64 0/1)."""
    d64 = ds.to(I64)
    n_pl = mont.p_planes(order_field(curve), d64)
    return (1 - bn.is_zero(d64)) & bn.cmp_lt(d64, n_pl)


def validate_public(qx, qy, curve: CurveSpec):
    """Batched partial public-key validation: canonical coordinates,
    on-curve, not the all-zero encoding. Returns an int64 0/1 mask."""
    fs = curve.field
    x64, y64 = qx.to(I64), qy.to(I64)
    p_pl = mont.p_planes(fs, x64)
    ok = bn.cmp_lt(x64, p_pl) & bn.cmp_lt(y64, p_pl)
    ok = ok & _on_curve(GFp.from_classical(qx, fs), GFp.from_classical(qy, fs), curve)
    return ok & (1 - (bn.is_zero(x64) & bn.is_zero(y64)))


def derive_public_planes(ds, curve: CurveSpec = P256):
    """Q_i = d_i * G on classical digit planes -> (qx, qy, ok): classical
    affine planes and the validity mask of the private keys."""
    ok = _scalar_ok(ds, curve)
    out = affine.to_affine(comb.scalar_mult_base(ds, curve))
    return out.x, out.y, ok.to(torch.int32)


def shared_secret_planes(ds, qx, qy, curve: CurveSpec = P256):
    """S_i = d_i * Q_i -> (sx, ok): the shared secrets' x planes and the
    validity mask (scalar in range AND peer key valid)."""
    ok = _scalar_ok(ds, curve) & validate_public(qx, qy, curve)
    d = curve.field.ndigits
    dev = ds.device
    g = [torch.from_numpy(convert.ints_to_planes([v], d)).to(dev) for v in (curve.gx, curve.gy)]
    qx = bn.select(ok, qx, g[0].expand_as(qx))
    qy = bn.select(ok, qy, g[1].expand_as(qy))
    one = torch.zeros_like(ds)
    one[0] = 1
    dss = bn.select(ok, ds, one)
    res = kglv.strict_varbase(dss.contiguous(), AffinePoint(qx, qy, curve))
    return affine.to_affine(res).x, ok.to(torch.int32)


def _planes(vals, curve: CurveSpec, device):
    return torch.from_numpy(convert.ints_to_planes(vals, curve.field.ndigits)).to(
        torch.device(device))


def derive_public_ints(ds, curve: CurveSpec = P256, device="cuda"):
    """Int-list key generation: [d_i] -> ([qx_i], [qy_i]). Raises on any
    out-of-range private key."""
    qx, qy, ok = derive_public_planes(_planes(ds, curve, device), curve)
    if not bool(ok.all()):
        raise ValueError("private key out of [1, n)")
    return convert.planes_to_ints(qx.cpu().numpy()), convert.planes_to_ints(qy.cpu().numpy())


def shared_secret_ints(ds, qxs, qys, curve: CurveSpec = P256, device="cuda"):
    """Int-list ECDH: returns ([sx_i or None], [ok_i]) — None where the
    scalar or the peer key failed validation."""
    pl = [_planes(v, curve, device) for v in (ds, qxs, qys)]
    sx, ok = shared_secret_planes(*pl, curve)
    oks = [bool(v) for v in ok.cpu()]
    xs = convert.planes_to_ints(sx.cpu().numpy())
    return [x if o else None for x, o in zip(xs, oks)], oks
