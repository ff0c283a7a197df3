"""GLV endomorphism scalar decomposition for j-invariant-0 curves (a = 0).

The port of ``ecsimd_tpu/glv.py``: the host-side derivation (``glv_params``,
``split_int``) is a copy, and ``split_planes`` is the device split on torch
digit planes, bit-identical to the JAX package's. ``tests/test_torch_glv.py``
holds both to the originals.

secp256k1-class curves y^2 = x^3 + b over p = 1 (mod 3) with n = 1 (mod 3)
carry the efficient endomorphism phi(x, y) = (beta*x, y) = [lambda]
(beta^3 = 1 mod p, lambda^3 = 1 mod n, Gallant-Lambert-Vanstone CRYPTO'01).
Splitting k = k1 + k2*lambda (mod n) with |k1|, |k2| ~ sqrt(n) halves the
doubling count of any window method: compute k1*P + k2*phi(P) with shared
doublings over ~128 bits instead of 256.

All constants are DERIVED host-side per curve at first use (cube roots of
unity, EEA lattice basis, Barrett constants) and validated against the
group law — nothing is hard-coded.

Decomposition layout: the exact-division rounding c_i = round(b_i * k / n)
becomes a Barrett multiply c_i = (k * g_i + 2^(t-1)) >> t with
g_i = round(2^t * |b_i| / n), t = 1.5 * nbits (384 for 256-bit curves) —
provably off by at most 1, which only widens |k_i| by |a_1| + |a_2| (still
< 2^(16*dk - 1)). Signed k_i travel as (magnitude, sign-mask) pairs in
dk-digit planes, two's-complement over 2^(16*(D+1)) internally.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from ecsimd_tpu_torch.ops import bignum as bn
from ecsimd_tpu_torch.ops.mont import _const_planes
from ecsimd_tpu_torch.oracle import coz
from ecsimd_tpu_torch.specs import DIGIT_BITS, CurveSpec, int_to_digits


def _barrett_shift(nbits: int) -> int:
    """t = 1.5 * nbits (digit-aligned for any nbits % 32 == 0): k < 2^nbits
    and |b_i| < 2^(nbits/2 + 1) make the Barrett error <= 1."""
    t = nbits * 3 // 2
    assert t % DIGIT_BITS == 0
    return t


@dataclasses.dataclass(frozen=True)
class GLVParams:
    beta: int  # cube root of 1 mod p with (beta*x, y) = lambda * (x, y)
    lam: int   # matching cube root of 1 mod n
    # lattice basis vectors (a1, b1), (a2, b2): a_i + b_i*lam = 0 (mod n)
    a1: int
    b1: int  # signed
    a2: int
    b2: int
    g1: int  # round(2^t *  b2 / n)
    g2: int  # round(2^t * -b1 / n)
    t: int   # Barrett shift (1.5 * nbits)
    dk: int  # digit width of the half-scalar magnitudes

    @property
    def max_half_bits(self) -> int:
        """Proven bound on |k1|, |k2| (basis norms + Barrett error 1)."""
        return max(
            abs(self.a1) + abs(self.a2), abs(self.b1) + abs(self.b2)
        ).bit_length() + 1


def _cube_roots(q: int) -> list[int]:
    assert q % 3 == 1
    for g in range(2, 1000):
        r = pow(g, (q - 1) // 3, q)
        if r != 1:
            return [r, r * r % q]
    raise ValueError("no cube root found")


@functools.cache
def glv_capable(curve: CurveSpec) -> bool:
    """Cheap host-side gate: can glv_params succeed for this curve?"""
    return (
        curve.a == 0 and curve.order_exact
        and curve.p % 3 == 1 and curve.order % 3 == 1
    )


@functools.cache
def glv_params(curve: CurveSpec) -> GLVParams:
    """Derive-and-validate the GLV constants for ``curve`` (a = 0,
    p = n = 1 mod 3, exact order required — lambda lives mod n)."""
    p, n = curve.p, curve.order
    assert curve.a == 0, "GLV endomorphism needs j-invariant 0 (a = 0)"
    assert curve.order_exact, "GLV needs the exact group order (lambda mod n)"
    assert p % 3 == 1 and n % 3 == 1, "GLV needs p = n = 1 (mod 3)"

    # pair beta with the lambda that satisfies lambda*G == (beta*gx, gy)
    beta = lam = None
    for b in _cube_roots(p):
        want = (b * curve.gx % p, curve.gy)
        for l in _cube_roots(n):
            if coz.scalar_mult_affine(l, curve.gx, curve.gy, curve) == want:
                beta, lam = b, l
                break
        if beta is not None:
            break
    assert beta is not None, "no (beta, lambda) pairing found"

    # EEA on (n, lam), stopping at the sqrt boundary (GLV §4)
    rs, ts = [n, lam], [0, 1]
    while rs[-1] * rs[-1] >= n:
        q = rs[-2] // rs[-1]
        rs.append(rs[-2] - q * rs[-1])
        ts.append(ts[-2] - q * ts[-1])
    a1, b1 = rs[-1], -ts[-1]
    # second vector: the shorter of (r_{l-1}, -t_{l-1}) and one more step
    q = rs[-2] // rs[-1]
    rn, tn = rs[-2] - q * rs[-1], ts[-2] - q * ts[-1]
    cand = [(rs[-2], -ts[-2]), (rn, -tn)]
    a2, b2 = min(cand, key=lambda v: v[0] * v[0] + v[1] * v[1])
    assert (a1 + b1 * lam) % n == 0 and (a2 + b2 * lam) % n == 0

    t = _barrett_shift(curve.field.nbits)
    g1 = (b2 * (1 << t) + n // 2) // n
    g2 = (-b1 * (1 << t) + n // 2) // n
    assert g1 > 0 and g2 > 0, "basis orientation: b2 > 0 > b1 expected"

    bound_bits = max(abs(a1) + abs(a2), abs(b1) + abs(b2)).bit_length() + 1
    dk = -(-(bound_bits + 1) // DIGIT_BITS)  # magnitudes fit with headroom
    params = GLVParams(beta, lam, a1, b1, a2, b2, g1, g2, t, dk)

    # self-check on a few scalars, including the lattice corners
    for k in (1, 2, lam, lam - 1, lam + 1, n - 1, n - 2, (n - 1) // 2):
        k1, s1, k2, s2 = split_int(k, params, n)
        v = ((-k1 if s1 else k1) + ((-k2 if s2 else k2) * lam)) % n
        assert v == k % n, f"split self-check failed for k={k:#x}"
        assert max(k1, k2).bit_length() <= params.max_half_bits
    return params


def split_int(k: int, params: GLVParams, n: int):
    """Host/oracle twin of the device split: returns (|k1|, neg1, |k2|,
    neg2) with k = sign1*|k1| + sign2*|k2|*lambda (mod n)."""
    t = params.t
    c1 = (k * params.g1 + (1 << (t - 1))) >> t
    c2 = (k * params.g2 + (1 << (t - 1))) >> t
    k1 = k - c1 * params.a1 - c2 * params.a2
    k2 = -c1 * params.b1 - c2 * params.b2
    return abs(k1), k1 < 0, abs(k2), k2 < 0


def split_planes(scalars, curve: CurveSpec):
    """Device GLV decomposition on classical digit planes.

    scalars: (D, *batch) classical planes, k in [0, 2^(16D)). Returns
    (k1, k2, neg1, neg2): two (dk, *batch) int64 magnitude planes and two
    (*batch,) int64 sign masks. Barrett multiplies and two's complement over
    2^(16*(D+1)) on int64 planes, on the tensors' device; uniform control
    flow (k never branches)."""
    params = glv_params(curve)
    d = scalars.shape[0]
    s64 = scalars.to(torch.int64)
    w = d + 1  # two's-complement width 2^(16*(d+1))
    t_digits = params.t // DIGIT_BITS
    cw = params.dk  # Barrett quotient width (c_i < 2^(nbits/2) + 1)

    def const(v: int, nd: int):
        return _const_planes(int_to_digits(v, nd), s64).expand((nd,) + s64.shape[1:])

    gw = d + 1  # g_i can be nbits+eps wide; one headroom digit
    kp = bn.pad(s64, gw)

    def barrett(g: int):
        prod = bn.mul(kp, const(g, gw))  # (2gw, *batch)
        rounded = bn.add(prod, const(1 << (params.t - 1), 2 * gw))[0]
        return rounded[t_digits : t_digits + cw]  # >> t, low cw digits

    c1 = barrett(params.g1)
    c2 = barrett(params.g2)

    def wmul(c, coef_abs: int):
        # c (cw digits) x |coef| -> low w digits (mod 2^(16w))
        return bn.mul(bn.pad(c, w), const(coef_abs, w))[:w]

    def signed_accum(init, terms):
        """init - sum(sign_i * term_i) over 2^(16w); host-side signs."""
        acc = init
        for term, sign in terms:
            acc = bn.sub(acc, term)[0] if sign > 0 else bn.add(acc, term)[0]
        return acc

    kw = bn.pad(s64, w)
    zero = torch.zeros_like(kw)
    # k1 = k - c1*a1 - c2*a2 ; k2 = -c1*b1 - c2*b2 (signs folded on the host)
    s1 = signed_accum(kw, [(wmul(c1, abs(params.a1)), 1 if params.a1 > 0 else -1),
                           (wmul(c2, abs(params.a2)), 1 if params.a2 > 0 else -1)])
    s2 = signed_accum(zero, [(wmul(c1, abs(params.b1)), 1 if params.b1 > 0 else -1),
                             (wmul(c2, abs(params.b2)), 1 if params.b2 > 0 else -1)])

    def mag_sign(s):
        negm = (s[w - 1] >> (DIGIT_BITS - 1)) & 1  # top bit of digit w-1
        mag = bn.select(negm, bn.sub(zero, s)[0], s)
        return mag[: params.dk], negm

    k1, neg1 = mag_sign(s1)
    k2, neg2 = mag_sign(s2)
    return k1, k2, neg1, neg2
