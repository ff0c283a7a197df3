"""L6: batched scalar-multiplication entry points.

The port of ``ecsimd_tpu/api.py``. Every function runs on the
device of its input tensors: on a CUDA tensor through the hand-written
kernels (``kernels/ladder.py``, ``kernels/window.py`` and ``kernels/glv.py``
for k_i * P_i, ``kernels/comb.py`` for k_i * B, ``kernels/batch_sum.py`` for
the sum of a batch, then ``kernels/affine.py`` for the affine conversion),
on a CPU tensor through their plain PyTorch versions. Both give
the same planes, so the affine results equal the JAX package's.
The constructors take ``device=`` and default to the card: with no card
they raise, and the CPU is used only when the caller asks for it.
"""

from __future__ import annotations

import torch

from ecsimd_tpu_torch import convert
from ecsimd_tpu_torch.curves.point import AffinePoint, JacobianPoint
from ecsimd_tpu_torch.kernels import affine, batch_sum, comb, glv, ladder, window
from ecsimd_tpu_torch.specs import P256, CurveSpec


def scalar_mult(scalars, points: AffinePoint) -> AffinePoint:
    """Batched constant-time k_i * P_i (the co-Z masked-swap ladder).
    Scalar domain k in [1, order-1)."""
    return affine.to_affine(ladder.scalar_mult(scalars, points))


def scalar_mult_p256(scalars, points: AffinePoint) -> AffinePoint:
    """k_i * P_i on NIST P-256."""
    if points.curve != P256:
        raise ValueError(f"scalar_mult_p256 takes P-256 points, got {points.curve.name}")
    return scalar_mult(scalars, points)


def scalar_mult_fast(scalars, points: AffinePoint, strict: bool = False) -> AffinePoint:
    """Batched constant-time k_i * P_i through the signed w = 4 window
    (masked lookups). Scalar domain: [1, order-1) minus a measure-zero
    degenerate class (``kernels/window.py``); ``strict=True`` uses complete
    adds and takes all of [1, order)."""
    return affine.to_affine(window.scalar_mult(scalars, points, strict=strict))


def scalar_mult_glv(scalars, points: AffinePoint, strict: bool = True) -> AffinePoint:
    """Batched k_i * P_i through the GLV endomorphism split, the
    variable-base path of j-invariant-0 curves (secp256k1): k = k1 + k2
    lambda with |k_i| ~ sqrt(n) halves the doublings (``kernels/glv.py``).
    ``strict`` defaults True: k = lambda makes k1 = 0, so the degenerate
    classes are easy to reach."""
    return affine.to_affine(glv.scalar_mult(scalars, points, strict=strict))


def shared_scalar_planes(k: int, curve: CurveSpec, batch: int, device) -> torch.Tensor:
    """The (D, batch) int32 planes of k mod 2^nbits in every lane: the bits
    the JAX package's shared-scalar ladder reads from k."""
    d = curve.field.ndigits
    kk = int(k) % (1 << curve.field.nbits)
    return _to(convert.broadcast_int(kk, d, 1), device).expand(d, batch).contiguous()


def scalar_mult_shared(k: int, points: AffinePoint) -> AffinePoint:
    """One host scalar k times every point of the batch through the co-Z
    ladder (kernel A on the card): bits 0 .. nbits - 1 of k, broadcast into
    the planes ``scalar_mult`` takes, so any int k is accepted. Scalar
    domain as ``scalar_mult``'s: k mod n in [1, order-1)."""
    scalars = shared_scalar_planes(k, points.curve, points.x.shape[-1], points.x.device)
    return scalar_mult(scalars, points)


def scalar_mult_shared_fast(k: int, points: AffinePoint) -> AffinePoint:
    """One host scalar k times every point of the batch: k broadcast into
    the planes that ``scalar_mult_fast`` takes."""
    d = points.curve.field.ndigits
    batch = points.x.shape[-1]
    scalars = torch.from_numpy(convert.broadcast_int(int(k), d, batch)).to(points.x.device)
    return scalar_mult_fast(scalars, points)


def scalar_mult_base(
    scalars, curve: CurveSpec = P256, base: tuple[int, int] | None = None,
    strict: bool = False,
) -> AffinePoint:
    """Fixed-base k_i * B for a base shared by every lane (default the
    curve generator) through the comb; tables are built on the host once per
    (curve, base, device). ``strict`` uses complete additions: scalar
    domain [1, order)."""
    return affine.to_affine(comb.scalar_mult_base(scalars, curve, base=base, strict=strict))


def multi_scalar_mult(scalars, points: AffinePoint, use_kernel: bool = True) -> JacobianPoint:
    """Multi-scalar multiplication: sum_i k_i * P_i over the whole flat batch,
    as a 1-lane Jacobian point in the field's internal form (it may be the
    point at infinity, z = 0: check before the affine conversion). Per-lane
    strict multiplications (``kernels/glv.strict_varbase``: the strict GLV
    chain on GLV-capable curves, the strict window otherwise; or, with
    ``use_kernel=False``, the co-Z ladder), then the pairwise tree of
    complete adds (``kernels/batch_sum.py``: kernel M on the card). Scalar
    domain per lane: [1, order) (the ladder's: [1, order-1))."""
    if not points.curve.order_exact:
        raise AssertionError(f"{points.curve.name}: order is a placeholder (order_exact=False)")
    if use_kernel:
        res = glv.strict_varbase(scalars, points)
    else:
        res = ladder.scalar_mult(scalars, points)
    return batch_sum.batch_sum(res)


# --- host-friendly integer interfaces ----------------------------------------


def _to(planes, device) -> torch.Tensor:
    return torch.from_numpy(planes).to(torch.device(device))


def generator_batch(curve: CurveSpec, batch: int, device="cuda") -> AffinePoint:
    """The curve generator broadcast across a batch."""
    d = curve.field.ndigits
    gx = _to(convert.broadcast_int(curve.gx, d, 1), device)
    gy = _to(convert.broadcast_int(curve.gy, d, 1), device)
    return AffinePoint(gx.expand(d, batch).contiguous(), gy.expand(d, batch).contiguous(), curve)


def points_from_ints(xs, ys, curve: CurveSpec, device="cuda") -> AffinePoint:
    d = curve.field.ndigits
    return AffinePoint(
        _to(convert.ints_to_planes(xs, d), device),
        _to(convert.ints_to_planes(ys, d), device),
        curve,
    )


def scalars_from_ints(ks, curve: CurveSpec, device="cuda"):
    return _to(convert.ints_to_planes(ks, curve.field.ndigits), device)


def multi_scalar_mult_ints(ks, xs, ys, curve: CurveSpec = P256, device="cuda", **kw):
    """Int-list MSM: the (x, y) ints of sum_i k_i * (x_i, y_i), or None for
    the point at infinity."""
    res = multi_scalar_mult(scalars_from_ints(ks, curve, device),
                            points_from_ints(xs, ys, curve, device), **kw)
    if bool(res.z.is_zero()[0]):
        return None
    out = affine.to_affine(res)
    return (convert.planes_to_ints(out.x.cpu().numpy())[0],
            convert.planes_to_ints(out.y.cpu().numpy())[0])


def scalar_mult_ints(ks, xs, ys, curve: CurveSpec = P256, device="cuda"):
    """Pure-int convenience API: returns (x, y) int lists."""
    pts = points_from_ints(xs, ys, curve, device)
    res = scalar_mult(scalars_from_ints(ks, curve, device), pts)
    return convert.planes_to_ints(res.x.cpu().numpy()), convert.planes_to_ints(res.y.cpu().numpy())
