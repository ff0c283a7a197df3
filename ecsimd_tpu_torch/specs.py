"""Field and curve specifications — all constants resolved at trace time.

The port's own copy of ``ecsimd_tpu/specs.py``: the port imports nothing of
the JAX package, and ``tests/test_torch_specs.py`` asserts that every curve
and field here equals the reference's, field by field. The port's specs are
distinct classes, so a port spec never ``==`` a reference spec; tests
rebuild reference specs as port specs (``tests/torch_helpers.port_spec``).

The reference resolves its per-prime constants (R, R^2 mod p, mprime, exponents)
at C++ compile time via ctbignum (``include/ecsimd/mgry_csts.h:10-28``,
``mgry_mul.h:25-50``). The TPU-native analogue is plain Python arbitrary-precision
integers computed once per spec and baked into traced/compiled kernels as constants.

Representation: a B-bit number is a vector of ``ndigits`` base-2^16 digits held in
int32 "limb planes" (structure-of-arrays, digit axis leading, batch axis trailing).
This is the reference's EVE product-type SoA layout (``bignum.h:38-102``) with the
batch widened from 4 SIMD lanes to thousands of TPU vector lanes, and the limb width
dropped from 64 to 16 bits so that digit products (16x16 -> 32) are exact in the
TPU VPU's 32-bit integer lanes — the same "half-width zero-extension" move the
reference makes from 64-bit limbs down to 32-bit half-limbs (``mul.h:63-83``).
"""

from __future__ import annotations

import dataclasses
import functools

DIGIT_BITS = 16
DIGIT_BASE = 1 << DIGIT_BITS
DIGIT_MASK = DIGIT_BASE - 1


@dataclasses.dataclass(frozen=True)
class FieldSpec:
    """A prime field GF(p) with fixed-width base-2^16 digit representation.

    Mirrors the role of the reference's ``mgry_constants``/``mgry_mul_constants``
    (``mgry_csts.h:10-28``, ``mgry_mul.h:25-50``): every derived constant is a
    Python int (or tuple of digit ints) computed eagerly so traced kernels embed
    them as literals.
    """

    name: str
    p: int
    nbits: int  # storage width in bits (multiple of DIGIT_BITS)
    # "montgomery": generic-prime CIOS (the reference's only strategy,
    # mgry_mul.h:84-121). "solinas": fast reduction for Solinas/NIST primes
    # whose 2^nbits residue decomposes into few +-1 power-of-2^32 terms —
    # a TPU-native specialization the reference lacks (its compile-time
    # constants make Montgomery free of per-prime cost on CPUs; on the TPU
    # VPU the CIOS multiplies are ~half the field-mul cost, so sparse primes
    # get a multiply-free reduction instead). "crandall": fold reduction for
    # p = 2^k - c with small c (P-521, Curve25519's 2^255 - 19) — needs only
    # cc = 2^nbits mod p small, not word-aligned terms (ops/crandall.py).
    reduction: str = "montgomery"

    def __post_init__(self):
        assert self.nbits % DIGIT_BITS == 0
        assert self.p % 2 == 1 and self.p.bit_length() <= self.nbits
        assert self.reduction in ("montgomery", "solinas", "crandall")
        if self.reduction == "crandall":
            k = self.p.bit_length()
            c = (1 << k) - self.p
            assert self.nbits > k and self.nbits - k < DIGIT_BITS
            assert (c << (self.nbits - k)) < (1 << 14), "fold multiplier too large"

    @property
    def plain(self) -> bool:
        """True when residues are stored plain (no Montgomery R factor):
        the solinas/crandall fast-reduction fields. These also support
        column-level fused reductions (scaled products, reduce_combo)."""
        return self.reduction != "montgomery"

    @property
    def ndigits(self) -> int:
        return self.nbits // DIGIT_BITS

    @functools.cached_property
    def R(self) -> int:
        # Montgomery radix: R = 2^nbits, same as the reference's
        # R = 2^(64*nlimbs) (mgry_csts.h:15) since nbits == 64*nlimbs there.
        return 1 << self.nbits

    @functools.cached_property
    def R_mod_p(self) -> int:
        return self.R % self.p

    @functools.cached_property
    def R2_mod_p(self) -> int:
        return (self.R * self.R) % self.p

    @functools.cached_property
    def R_inv(self) -> int:
        return pow(self.R, -1, self.p)

    def R2_digits(self) -> tuple[int, ...]:
        return int_to_digits(self.R2_mod_p, self.ndigits)

    @functools.cached_property
    def mprime(self) -> int:
        # -p^-1 mod 2^DIGIT_BITS; reference computes -p^-1 mod 2^32 for its
        # 32-bit half-limbs (mgry_mul.h:33-40). One more halving step here.
        return (-pow(self.p, -1, DIGIT_BASE)) % DIGIT_BASE

    @functools.cached_property
    def p_digits(self) -> tuple[int, ...]:
        return int_to_digits(self.p, self.ndigits)

    @functools.cached_property
    def fermat_exponent(self) -> int:
        # inverse(x) = x^(p-2); reference gfp.h:42-44,80-81.
        return self.p - 2

    @functools.cached_property
    def sqrt_exponent(self) -> int:
        # sqrt(x) = x^((p+1)/4) requires p = 3 mod 4; reference gfp.h:84-87.
        assert self.p % 4 == 3, "sqrt exponent requires p = 3 (mod 4)"
        return (self.p + 1) // 4

    # --- p = 1 (mod 4) square-root constants -------------------------------
    # Beyond the reference (gfp.h:84-87 static_asserts p = 3 mod 4 and
    # supports nothing else): every odd prime gets a sqrt path. p = 5 (mod 8)
    # uses the Atkin shape x^((p+3)/8) with a sqrt(-1) fixup (Wei25519);
    # anything else falls back to uniform-control-flow Tonelli-Shanks.

    @functools.cached_property
    def sqrt_kind(self) -> str:
        if self.p % 4 == 3:
            return "p3mod4"
        if self.p % 8 == 5:
            return "p5mod8"
        return "tonelli"

    @functools.cached_property
    def sqrt_m1(self) -> int:
        """sqrt(-1) mod p for p = 5 (mod 8): 2 is a non-residue there
        (2 is a QR iff p = +-1 mod 8), so 2^((p-1)/4) is a primitive
        4th root of unity."""
        assert self.p % 8 == 5
        return pow(2, (self.p - 1) // 4, self.p)

    @functools.cached_property
    def ts_params(self) -> tuple[int, int, int]:
        """(q, s, c) for Tonelli-Shanks: p - 1 = q * 2^s with q odd, and
        c = z^q mod p for the smallest quadratic non-residue z — all
        host-side; the device never exponentiates by a secret."""
        p = self.p
        q, s = p - 1, 0
        while q % 2 == 0:
            q //= 2
            s += 1
        z = 2
        while pow(z, (p - 1) // 2, p) != p - 1:
            z += 1
        return q, s, pow(z, q, p)


@dataclasses.dataclass(frozen=True)
class CurveSpec:
    """Short-Weierstrass curve y^2 = x^3 + a*x + b.

    Mirrors the reference's curve concept + P-256 definition
    (``curve.h:12-15``, ``curve_nist_p256.h:14-32``). The reference's concept
    requires a = -3; here the co-Z group law and ladders are generic in a
    (dblu folds a into its trace-time constant; the co-Z adds never touch
    it), so any odd-order short-Weierstrass curve works — only the window
    kernel's dbl-2001-b doubling asserts a = -3 at trace time.
    """

    name: str
    field: FieldSpec
    a: int
    b: int
    gx: int
    gy: int
    order: int
    # True when ``order`` is the exact group order of <G>. Test-only toy
    # curves may carry an odd placeholder (the ladder/window algorithms never
    # consult the value) and must set False — every path whose ARITHMETIC
    # uses the order (the ECDSA mod-n scalar field, ECDH range checks, MSM)
    # asserts this at trace time, so a placeholder order fails loudly
    # instead of producing silently-wrong protocol results.
    order_exact: bool = True

    def __post_init__(self):
        p = self.field.p
        assert (self.gy * self.gy - (self.gx**3 + self.a * self.gx + self.b)) % p == 0
        assert self.order % 2 == 1  # ladder's force-odd trick needs odd order

    @property
    def p(self) -> int:
        return self.field.p

    @property
    def am3(self) -> bool:
        """True for the reference's wst_curve_am3 shape (a = -3 mod p)."""
        return self.a == self.field.p - 3


def int_to_digits(x: int, ndigits: int) -> tuple[int, ...]:
    """Little-endian base-2^16 digit decomposition."""
    assert 0 <= x < (1 << (ndigits * DIGIT_BITS))
    return tuple((x >> (DIGIT_BITS * i)) & DIGIT_MASK for i in range(ndigits))


def digits_to_int(digits) -> int:
    return sum(int(d) << (DIGIT_BITS * i) for i, d in enumerate(digits))


# --- Standard fields -------------------------------------------------------

# NIST P-256 prime (curve_nist_p256.h:17)
P256_FIELD = FieldSpec(
    name="p256",
    p=0xFFFFFFFF00000001000000000000000000000000FFFFFFFFFFFFFFFFFFFFFFFF,
    nbits=256,
    reduction="solinas",
)

# secp256k1 prime — used throughout the reference's Montgomery tests
# (tests/mgry.cpp:26, tests/ops.cpp:223) though the reference defines no
# secp256k1 *curve*.
SECP256K1_FIELD = FieldSpec(
    name="secp256k1",
    p=0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEFFFFFC2F,
    nbits=256,
)

# --- Standard curves -------------------------------------------------------

# NIST P-256 (curve_nist_p256.h:14-32; order from SP 800-186)
P256 = CurveSpec(
    name="nist-p256",
    field=P256_FIELD,
    a=0xFFFFFFFF00000001000000000000000000000000FFFFFFFFFFFFFFFFFFFFFFFC,
    b=0x5AC635D8AA3A93E7B3EBBD55769886BC651D06B0CC53B0F63BCE3C3E27D2604B,
    gx=0x6B17D1F2E12C4247F8BCE6E563A440F277037D812DEB33A0F4A13945D898C296,
    gy=0x4FE342E2FE1A7F9B8EE7EB4A7C0F9E162BCE33576B315ECECBB6406837BF51F5,
    order=0xFFFFFFFF00000000FFFFFFFFFFFFFFFFBCE6FAADA7179E84F3B9CAC2FC632551,
)

# NIST P-384 — not in the reference; included because the framework is generic
# over wst_curve_am3-style curves (a = -3, p = 3 mod 4).
P384_FIELD = FieldSpec(
    name="p384",
    p=0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEFFFFFFFF0000000000000000FFFFFFFF,
    nbits=384,
    reduction="solinas",
)

P384 = CurveSpec(
    name="nist-p384",
    field=P384_FIELD,
    a=P384_FIELD.p - 3,
    b=0xB3312FA7E23EE7E4988E056BE3F82D19181D9C6EFE8141120314088F5013875AC656398D8A2ED19D2A85C8EDD3EC2AEF,
    gx=0xAA87CA22BE8B05378EB1C71EF320AD746E1D3B628BA79B9859F741E082542A385502F25DBF55296C3A545E3872760AB7,
    gy=0x3617DE4A96262C6F5D9E98BF9292DC29F8F41DBD289A147CE9DA3113B5F0B8C00A60B1CE1D7E819D7A431D7C90EA0E5F,
    order=0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFC7634D81F4372DDF581A0DB248B0A77AECEC196ACCC52973,
)

# secp256k1 (a = 0, Montgomery-reduction field) — beyond the reference, which
# uses this prime only in its Montgomery tests; the generic-a group law and
# CIOS field path make the full curve available (XLA + ladder-kernel paths;
# the a = -3 window/comb fast paths decline it at trace time).
SECP256K1 = CurveSpec(
    name="secp256k1",
    field=SECP256K1_FIELD,
    a=0,
    b=7,
    gx=0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798,
    gy=0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8,
    order=0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141,
)

# NIST P-521 — beyond the reference. p = 2^521 - 1 (Mersenne) stored in 33
# digits (nbits = 528). The Solinas planner requires word-aligned +-1/+-2
# folds (2^528 mod p = 2^7 doesn't qualify); the Crandall fold reduction
# (ops/crandall.py, cc = 2^7) fits exactly and roughly halves the field-mul
# cost vs generic CIOS. a = -3 and p = 3 (mod 4), so every fast path
# (window/comb kernels, sqrt decompression) accepts it.
P521_FIELD = FieldSpec(
    name="p521",
    p=(1 << 521) - 1,
    nbits=528,
    reduction="crandall",
)

P521 = CurveSpec(
    name="nist-p521",
    field=P521_FIELD,
    a=P521_FIELD.p - 3,
    b=0x0051953EB9618E1C9A1F929A21A0B68540EEA2DA725B99B315F3B8B489918EF109E156193951EC7E937B1652C0BD3BB1BF073573DF883D2C34F1EF451FD46B503F00,
    gx=0x00C6858E06B70404E9CD9E3ECB662395B4429C648139053FB521F828AF606B4D3DBAA14B5E77EFE75928FE1DC127A2FFA8DE3348B3C1856A429BF97E7E31C2E5BD66,
    gy=0x011839296A789A3BC0045C8A5FB42C7D1BD998F54449579B446817AFBD17273E662C97EE72995EF42640C550B9013FAD0761353C7086A272C24088BE94769FD16650,
    order=0x01FFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFA51868783BF2F966B7FCC0148F709A5D03BB5C9B8899C47AEBB6FB71E91386409,
)

# Wei25519 — Curve25519 (RFC 7748) in short-Weierstrass form via the standard
# Montgomery->Weierstrass map x = u + A/3, y = v (A = 486662, p = 2^255 - 19);
# constants derived and verified at build time (order * G = infinity against
# an independent naive Jacobian implementation). The spec's order is the odd
# prime-order subgroup order l = 2^252 + 27742...493 (the full group has
# cofactor 8; the generator below generates the order-l subgroup, satisfying
# the framework's odd-order requirement). p = 5 (mod 8): sqrt/decompression
# runs through the Atkin path (FieldSpec.sqrt_kind "p5mod8"); scalar mult
# paths all work (generic-a group law + the Crandall fold field, cc = 38).
W25519_FIELD = FieldSpec(
    name="w25519",
    p=(1 << 255) - 19,
    nbits=256,
    reduction="crandall",
)

WEI25519 = CurveSpec(
    name="wei25519",
    field=W25519_FIELD,
    a=0x2AAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAA984914A144,
    b=0x7B425ED097B425ED097B425ED097B425ED097B425ED097B4260B5E9C7710C864,
    gx=0x2AAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAD245A,
    gy=0x20AE19A1B8A086B4E01EDD2C7748D14C923D4D7E6D7C61B229E9C5A27ECED3D9,
    order=0x1000000000000000000000000000000014DEF9DEA2F79CD65812631A5CF5D3ED,
)

CURVES = {c.name: c for c in (P256, P384, P521, SECP256K1, WEI25519)}
FIELDS = {f.name: f for f in (P256_FIELD, SECP256K1_FIELD, P384_FIELD, P521_FIELD, W25519_FIELD)}
