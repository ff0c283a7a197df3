"""Batched ECDSA: signing, verification and public-key recovery.

The port of ``ecsimd_tpu/ecdsa.py`` (sharded variants aside, ROADMAP A11).
Per lane, as FIPS 186-5 / SEC 1 v2 section 4.1:

- ``sign_planes``: R = k G; r = R.x mod n; s = k^-1 (e + r d) mod n.
- ``verify_planes``: w = s^-1; u1 = e w, u2 = r w; R = u1 G + u2 Q;
  accept iff R != inf and R.x == r (mod n), checked projectively
  (X == r_hat Z^2 for r_hat in {r, r + n < p}) with no inversion.
- ``recover_planes``: Q = r^-1 (s R - e G), R decompressed from r and the
  recovery id v (bit 0: parity of R.y, bit 1: R.x = r + n).

Routing is the JAX package's. k G goes through the comb (kernel B on the
card). The verify and recover scalar multiplications take attacker-chosen
scalars, so they run the strict variable-base chain: the GLV chain on
GLV-capable curves (kernel F strict, secp256k1), the strict window
otherwise (kernel E strict, P-256). ``allow_fast_paths=True`` puts u1 G on
the comb and, off the GLV curves, u2 Q on the plain window, as the JAX
package does. The one deliberate difference: on a GLV curve the JAX
package then runs u2 Q, whose u2 = r / s the signer chooses, through the
plain GLV chain, whose domain is trusted uniform scalars (u2 = lambda gives
k1 = 0); the port keeps the strict GLV chain for u2 Q in every mode
(``tests/test_torch_ecdsa.py`` pins it). Recovery checks that the candidate
x is below p on every lane, not only where v says r + n.

The order-field arithmetic (s^-1, u1, u2, the batch inverse mod n) and
recovery's square root run as plain PyTorch on the tensors' device, over
the CIOS Montgomery field of ``order_field`` — as the JAX package runs them
in plain XLA. The final add is the complete ``group.jac_add_complete``:
u1 G == +-u2 Q and infinite operands are reachable by an attacker.

Inputs are (D, B) int32 classical digit planes (z any nbits-bit hash int,
reduced mod n by one conditional subtract); masks are (B,) int32 0/1.
RFC 6979 nonces (``rfc6979_nonce``, ``sign_hashes``) are derived on the
host.
"""

from __future__ import annotations

import functools
import hashlib
import hmac
import secrets

import torch

from ecsimd_tpu_torch import convert
from ecsimd_tpu_torch.curves import group
from ecsimd_tpu_torch.curves.point import AffinePoint, JacobianPoint
from ecsimd_tpu_torch.field import GFp
from ecsimd_tpu_torch.glv import glv_capable
from ecsimd_tpu_torch.kernels import affine, comb, window
from ecsimd_tpu_torch.kernels import glv as kglv
from ecsimd_tpu_torch.ops import bignum as bn
from ecsimd_tpu_torch.ops import mont
from ecsimd_tpu_torch.specs import P256, CurveSpec, FieldSpec

I32, I64 = torch.int32, torch.int64


@functools.cache
def order_field(curve: CurveSpec) -> FieldSpec:
    """GF(n) for the curve's (prime) group order with Montgomery (CIOS)
    reduction, as the JAX package builds it: the scalar field of ECDSA.
    Requires an exact order (``CurveSpec.order_exact``)."""
    assert curve.order_exact, (
        f"{curve.name}: order is a placeholder (order_exact=False); "
        "ECDSA/ECDH/MSM need the exact group order"
    )
    return FieldSpec(
        name=f"{curve.name}-order", p=curve.order,
        nbits=curve.field.nbits, reduction="montgomery",
    )


def curve_order_big_enough(fs_n: FieldSpec) -> bool:
    return fs_n.p.bit_length() >= fs_n.nbits  # 2^nbits < 2n


def _mod_n(planes, fs_n: FieldSpec):
    """Reduce full-width classical int64 planes mod n with one conditional
    subtract (valid because inputs are < 2^nbits < 2n)."""
    assert curve_order_big_enough(fs_n)
    return bn.sub_if_above(planes, mont.p_planes(fs_n, planes))


def _on_curve(qx: GFp, qy: GFp, curve: CurveSpec):
    """Per-lane int64 0/1 mask: y^2 == x^3 + a x + b in GF(p)."""
    a, b = qx.const_like(curve.a), qx.const_like(curve.b)
    lhs = qy.sqr()
    rhs = (qx.sqr() + a) * qx + b
    return lhs.eq(rhs)


def _one_like(planes):
    """The classical value 1 in int64 planes shaped like ``planes``."""
    one = torch.zeros_like(planes)
    one[0] = 1
    return one


def _in_range(v, n_pl):
    """1 <= v < n, lane-wise."""
    return (1 - bn.is_zero(v)) & bn.cmp_lt(v, n_pl)


def _generator(curve: CurveSpec, like) -> AffinePoint:
    """The generator broadcast over the lanes of ``like`` (int32 planes)."""
    d = curve.field.ndigits
    g = [torch.from_numpy(convert.ints_to_planes([v], d)).to(like.device).expand_as(like)
         for v in (curve.gx, curve.gy)]
    return AffinePoint(g[0].contiguous(), g[1].contiguous(), curve)


def _batch_inverse_mont(am, fs_n: FieldSpec):
    """Montgomery-form inverses mod n of int64 Montgomery planes (zero lanes
    give 0), one shared inversion for the batch."""
    return GFp(am.to(I32), fs_n).batch_inverse().planes.to(I64)


def verify_planes(z, r, s, qx, qy, curve: CurveSpec, allow_fast_paths: bool = False):
    """Batched ECDSA verification on classical digit planes: (B,) int32
    validity mask."""
    fs, fs_n = curve.field, order_field(curve)
    z64, r64, s64 = (t.to(I64) for t in (z, r, s))
    n_pl = mont.p_planes(fs_n, r64)
    ok = _in_range(r64, n_pl) & _in_range(s64, n_pl)
    ok = ok & _on_curve(GFp.from_classical(qx, fs), GFp.from_classical(qy, fs), curve)

    # w = s^-1, u1 = e w, u2 = r w mod n. s == 0 lanes (already invalid) are
    # steered to 1 so that the inverse and u2 stay in the scalar domain.
    sm = mont.mont_from_classical(s64, fs_n)
    sm = bn.select(bn.is_zero(sm), mont.mont_one(fs_n, sm), sm)
    wm = _batch_inverse_mont(sm, fs_n)
    em = mont.mont_from_classical(_mod_n(z64, fs_n), fs_n)
    rm = mont.mont_from_classical(r64, fs_n)
    u1 = mont.mont_to_classical(mont.mont_mul(em, wm, fs_n), fs_n)
    u2 = mont.mont_to_classical(mont.mont_mul(rm, wm, fs_n), fs_n)
    one = _one_like(u1)
    u2 = bn.select(bn.is_zero(u2), one, u2)  # only on lanes already invalid
    u1_zero = bn.is_zero(u1)  # e == 0 mod n: R = u2 Q alone (a valid input)
    u1s = bn.select(u1_zero, one, u1)

    u1s, u2 = u1s.to(I32), u2.to(I32)
    q = AffinePoint(qx.contiguous(), qy.contiguous(), curve)
    if allow_fast_paths:
        s1 = comb.scalar_mult_base(u1s, curve)
        fast_u2 = not glv_capable(curve)  # GLV curves keep the strict chain
        s2 = window.scalar_mult(u2, q, strict=False) if fast_u2 else kglv.strict_varbase(u2, q)
    else:
        s1 = kglv.strict_varbase(u1s, _generator(curve, u1s))
        s2 = kglv.strict_varbase(u2, q)

    # u1 == 0 lanes: S1 becomes infinity, so R = S2 (complete add)
    z1 = s1.z.select(1 - u1_zero, s1.z.const_like(0))
    rpt = group.jac_add_complete(JacobianPoint(s1.x, s1.y, z1, curve), s2)
    ok = ok & (1 - rpt.z.is_zero())
    # projective x check: X == r_hat Z^2 for r_hat in {r, r + n < p}
    zz = rpt.z.sqr()
    m1 = rpt.x.eq(GFp.from_classical(r, fs) * zz)
    rn, carry = bn.add(r64, n_pl)
    rn_ok = (1 - carry) & bn.cmp_lt(rn, mont.p_planes(fs, r64))
    m2 = rn_ok & rpt.x.eq(GFp.from_classical(bn.select(rn_ok, rn, r64).to(I32), fs) * zz)
    return (ok & (m1 | m2)).to(I32)


def recover_planes(z, r, s, v, curve: CurveSpec):
    """Batched public-key recovery (SEC 1 v2 section 4.1.6, cofactor 1).

    z, r, s: (D, B) classical planes; v: (B,) recovery ids in [0, 3].
    Returns (qx, qy, ok): classical affine planes of Q (zero on failed
    lanes) and the (B,) int32 validity mask. Both scalar multiplications are
    strict: recovery exists to process foreign signatures."""
    fs, fs_n = curve.field, order_field(curve)
    z64, r64, s64, v64 = (t.to(I64) for t in (z, r, s, v))
    n_pl = mont.p_planes(fs_n, r64)
    p_pl = mont.p_planes(fs, r64)
    ok = _in_range(r64, n_pl) & _in_range(s64, n_pl) & (v64 >= 0) & (v64 <= 3)
    # candidate R.x = r (+ n when v bit 1): no carry, and below p on every lane
    xn, carry = bn.add(r64, n_pl)
    hi = (v64 >> 1) & 1
    x_cand = bn.select(hi, xn, r64)
    ok = ok & (1 - (hi & carry)) & bn.cmp_lt(x_cand, p_pl)
    one = _one_like(r64)
    x_cand = bn.select(ok, x_cand, one)

    dec, sqrt_ok = group.affine_from_x(x_cand.to(I32), curve)
    ok = ok & sqrt_ok
    ydec = GFp.from_classical(dec.y, fs)
    same_parity = ((dec.y[0].to(I64) & 1) == (v64 & 1)).to(I64)
    ry = ydec.select(same_parity, ydec.opposite()).to_classical()
    # invalid lanes are steered to G, so the kernels' bases are curve points
    g = _generator(curve, r)
    rx_s = bn.select(ok, x_cand, g.x.to(I64)).to(I32)
    ry_s = bn.select(ok, ry, g.y).contiguous()

    # r^-1 mod n (shared inversion); u1 = -e r^-1, u2 = s r^-1
    rm = mont.mont_from_classical(r64, fs_n)
    rm = bn.select(bn.is_zero(rm), mont.mont_one(fs_n, rm), rm)
    rinv = _batch_inverse_mont(rm, fs_n)
    em = mont.mont_from_classical(_mod_n(z64, fs_n), fs_n)
    sm = mont.mont_from_classical(s64, fs_n)
    u1p = mont.mont_to_classical(mont.mont_mul(em, rinv, fs_n), fs_n)
    u1 = bn.select(bn.is_zero(u1p), u1p, bn.sub(n_pl, u1p)[0])
    u2 = mont.mont_to_classical(mont.mont_mul(sm, rinv, fs_n), fs_n)
    u2 = bn.select(bn.is_zero(u2), one, u2)  # only on lanes already invalid
    u1_zero = bn.is_zero(u1)
    u1s = bn.select(u1_zero, one, u1)

    s1 = kglv.strict_varbase(u1s.to(I32), g)
    s2 = kglv.strict_varbase(u2.to(I32), AffinePoint(rx_s, ry_s, curve))
    z1 = s1.z.select(1 - u1_zero, s1.z.const_like(0))
    q = group.jac_add_complete(JacobianPoint(s1.x, s1.y, z1, curve), s2)
    ok = ok & (1 - q.z.is_zero())
    aff = affine.to_affine(q)
    zero = torch.zeros_like(aff.x)
    return bn.select(ok, aff.x, zero), bn.select(ok, aff.y, zero), ok.to(I32)


def sign_planes(z, d, k, curve: CurveSpec, strict: bool = False):
    """Batched ECDSA signing on classical digit planes.

    z: (D, B) hash planes; d: private keys in [1, n-1]; k: uniform nonces in
    [1, n-1] (``sign_ints`` draws them, ``sign_hashes`` derives them per RFC
    6979). Returns (r, s, ok): int32 planes and the (B,) int32 mask; ok == 0
    lanes (r or s == 0, or inputs out of range) need a fresh nonce.
    ``strict`` runs the complete-add comb (scalar domain [1, n))."""
    fs_n = order_field(curve)
    z64, d64, k64 = (t.to(I64) for t in (z, d, k))
    n_pl = mont.p_planes(fs_n, k64)
    ok = _in_range(k64, n_pl) & _in_range(d64, n_pl)
    # k == 0 lanes (already invalid) steered to 1 so the comb domain holds
    ks = bn.select(bn.is_zero(k64), _one_like(k64), k64)

    rp = comb.scalar_mult_base(ks.to(I32), curve, strict=strict)
    r = _mod_n(affine.to_affine(rp).x.to(I64), fs_n)
    ok = ok & (1 - bn.is_zero(r))

    kinv = _batch_inverse_mont(mont.mont_from_classical(ks, fs_n), fs_n)
    em = mont.mont_from_classical(_mod_n(z64, fs_n), fs_n)
    rd = mont.mont_mul(mont.mont_from_classical(r, fs_n), mont.mont_from_classical(d64, fs_n),
                       fs_n)
    s = mont.mont_to_classical(mont.mont_mul(kinv, mont.mod_add(em, rd, fs_n), fs_n), fs_n)
    ok = ok & (1 - bn.is_zero(s))
    return r.to(I32), s.to(I32), ok.to(I32)


# --- RFC 6979 deterministic nonces (host-side) --------------------------------


def _bits2int(b: bytes, qlen: int) -> int:
    """RFC 6979 section 2.3.2: leftmost qlen bits of the bit string."""
    x = int.from_bytes(b, "big")
    blen = len(b) * 8
    return x >> (blen - qlen) if blen > qlen else x


def rfc6979_nonce(h1: bytes, x: int, curve: CurveSpec = P256, hashfunc=None,
                  extra: bytes = b"") -> int:
    """RFC 6979 section 3.2 deterministic nonce k for private key x and
    message digest h1 (raw bytes): HMAC-DRBG on the host, before anything
    touches the device. ``hashfunc`` is the HMAC hash (default SHA-256);
    ``extra`` the optional k' data of section 3.6."""
    hashfunc = hashfunc or hashlib.sha256
    q = curve.order
    qlen = q.bit_length()
    rolen = (qlen + 7) // 8
    hlen = hashfunc().digest_size

    def int2octets(v: int) -> bytes:
        return v.to_bytes(rolen, "big")

    def bits2octets(b: bytes) -> bytes:
        z1 = _bits2int(b, qlen)
        return int2octets(z1 - q if z1 >= q else z1)

    def hm(key: bytes, msg: bytes) -> bytes:
        return hmac.new(key, msg, hashfunc).digest()

    v = b"\x01" * hlen
    k = b"\x00" * hlen
    seed = int2octets(x) + bits2octets(h1) + extra
    k = hm(k, v + b"\x00" + seed)
    v = hm(k, v)
    k = hm(k, v + b"\x01" + seed)
    v = hm(k, v)
    while True:
        t = b""
        while len(t) < rolen:
            v = hm(k, v)
            t += v
        kk = _bits2int(t[:rolen], qlen)
        if 1 <= kk <= q - 1:
            return kk
        k = hm(k, v + b"\x00")
        v = hm(k, v)


# --- host-friendly integer interfaces ----------------------------------------


def _planes(vals, curve: CurveSpec, device):
    return torch.from_numpy(convert.ints_to_planes(vals, curve.field.ndigits)).to(
        torch.device(device))


def sign_ints(zs, ds, curve: CurveSpec = P256, ks=None, device="cuda", strict: bool = False):
    """Int-list signing: uniform nonces from the OS CSPRNG unless ``ks`` is
    given. Returns (rs, ss); raises where a lane needs a fresh nonce."""
    if ks is None:
        ks = [1 + secrets.randbelow(curve.order - 1) for _ in zs]
    r, s, ok = sign_planes(*(_planes(v, curve, device) for v in (zs, ds, ks)), curve,
                           strict=strict)
    if not bool(ok.all()):
        raise ValueError("nonce produced r == 0 or s == 0, or an input is out of range")
    return convert.planes_to_ints(r.cpu().numpy()), convert.planes_to_ints(s.cpu().numpy())


def sign_hashes(h1s, ds, curve: CurveSpec = P256, deterministic: bool = True, hashfunc=None,
                **kw):
    """Batched signing from raw message digests: RFC 6979 nonces when
    ``deterministic``, else the OS CSPRNG. Returns (rs, ss)."""
    qlen = curve.order.bit_length()
    zs = [_bits2int(h, qlen) for h in h1s]
    ks = None
    if deterministic:
        ks = [rfc6979_nonce(h, d, curve, hashfunc=hashfunc) for h, d in zip(h1s, ds)]
    return sign_ints(zs, ds, curve, ks=ks, **kw)


def verify_ints(zs, rs, ss, qxs, qys, curve: CurveSpec = P256, device="cuda",
                **kw) -> list[bool]:
    """Int-list verification: one bool per signature."""
    pl = [_planes(v, curve, device) for v in (zs, rs, ss, qxs, qys)]
    return [bool(v) for v in verify_planes(*pl, curve, **kw).cpu()]


def recover_ints(zs, rs, ss, vs, curve: CurveSpec = P256, device="cuda", **kw):
    """Int-list public-key recovery: a list of (qx, qy) or None."""
    pl = [_planes(v, curve, device) for v in (zs, rs, ss)]
    v = torch.tensor(list(vs), dtype=I32, device=torch.device(device))
    qx, qy, ok = recover_planes(*pl, v, curve, **kw)
    xs = convert.planes_to_ints(qx.cpu().numpy())
    ys = convert.planes_to_ints(qy.cpu().numpy())
    return [(x, y) if bool(o) else None for x, y, o in zip(xs, ys, ok.cpu())]
