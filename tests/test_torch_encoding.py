"""SEC1 encoding in the port (``ecsimd_tpu_torch/encoding.py``): the
encoder's bytes against the JAX package's ``points_to_bytes`` on the same
numpy planes (no JAX operation runs), the decoder against a Python-int SEC1
decoder on P-256 and against the JAX package's decoder on one TOYM batch of
8 lanes holding every invalid form. Inputs from
numpy.random.default_rng(seed). Tolerance: exact."""

import numpy as np
import pytest

from ecsimd_tpu import encoding as jenc
from ecsimd_tpu.curves.point import AffinePoint as JAffine
from ecsimd_tpu.oracle import coz as ocoz
from ecsimd_tpu.specs import P256, P521, SECP256K1, WEI25519
from ecsimd_tpu_torch import encoding
from ecsimd_tpu_torch.curves.point import AffinePoint
from tests.toy import TOYM
from tests.torch_helpers import ints, planes, port_spec, tplanes


def _points(curve, rng, n):
    """n affine points k G, random k."""
    return [ocoz.scalar_mult_affine(int(k) % (curve.order - 2) + 1, curve.gx, curve.gy, curve)
            for k in rng.integers(1, 1 << 62, size=n)]


@pytest.mark.parametrize("curve", [TOYM, P256, SECP256K1, WEI25519, P521],
                         ids=lambda c: c.name)
def test_encoder_bytes_equal_the_reference(curve):
    rng = np.random.default_rng(160)
    pts = _points(curve, rng, 6) + [(0, 0), (curve.p - 1, 1)]
    d = curve.field.ndigits
    xs, ys = planes([x for x, _ in pts], d), planes([y for _, y in pts], d)
    ours = AffinePoint(tplanes([x for x, _ in pts], d), tplanes([y for _, y in pts], d),
                       port_spec(curve))
    ref = JAffine(xs, ys, curve)  # numpy planes: the encoder runs no JAX operation
    length = encoding.coordinate_bytes(ours.curve)
    assert length == jenc.coordinate_bytes(curve)
    for compressed in (True, False):
        got = encoding.points_to_bytes(ours, compressed)
        assert got == jenc.points_to_bytes(ref, compressed)
        assert all(len(b) == 1 + length * (1 if compressed else 2) for b in got)


def _decode_int(blob, curve):
    """SEC1 decoding on Python ints: ((x, y), ok), (0, 0) where not ok."""
    p, length = curve.p, (curve.p.bit_length() + 7) // 8
    if len(blob) == 1 + length and blob[0] in (2, 3):
        x = int.from_bytes(blob[1:], "big")
        if x >= p:
            return (0, 0), False
        rhs = (x ** 3 + curve.a * x + curve.b) % p
        y = pow(rhs, (p + 1) // 4, p)  # p = 3 mod 4
        if y * y % p != rhs:
            return (0, 0), False
        if y & 1 != blob[0] & 1:
            y = (p - y) % p
        return (x, y), True
    if len(blob) == 1 + 2 * length and blob[0] == 4:
        x, y = int.from_bytes(blob[1:1 + length], "big"), int.from_bytes(blob[1 + length:], "big")
        ok = x < p and y < p and (x, y) != (0, 0) and (
            y * y - x ** 3 - curve.a * x - curve.b) % p == 0
        return ((x, y), True) if ok else ((0, 0), False)
    return (0, 0), False


def _invalid_forms(curve, pt):
    """One blob of each invalid form, and a valid lane of each kind."""
    p, length = curve.p, (curve.p.bit_length() + 7) // 8
    x, y = pt
    enc = lambda v: v.to_bytes(length, "big")  # noqa: E731
    nonres = next(v for v in range(2, 200)
                  if pow((v ** 3 + curve.a * v + curve.b) % p, (p - 1) // 2, p) == p - 1)
    return [
        bytes([2 | (y & 1)]) + enc(x),  # valid, compressed
        b"\x04" + enc(x) + enc(y),  # valid, uncompressed
        b"\x05" + enc(x),  # bad prefix
        b"\x02" + enc(x)[1:],  # bad length
        b"\x03" + enc(p),  # x = p
        b"\x04" + enc(x) + enc((y + 1) % p),  # off the curve
        b"\x00",  # infinity
        b"\x02" + enc(nonres),  # x not on the curve
    ]


def test_decoder_matches_the_reference_on_every_invalid_form():
    """TOYM (p = 3 mod 4), one batch of 8 lanes: the port's points and ok
    mask against the JAX package's decoder and the int decoder."""
    curve = TOYM
    rng = np.random.default_rng(161)
    blobs = _invalid_forms(curve, _points(curve, rng, 1)[0])
    pt, ok = encoding.points_from_bytes(blobs, port_spec(curve), device="cpu")
    jpt, jok = jenc.points_from_bytes(blobs, curve)
    np.testing.assert_array_equal(ok, np.asarray(jok))
    np.testing.assert_array_equal(pt.x.numpy(), np.asarray(jpt.x))
    np.testing.assert_array_equal(pt.y.numpy(), np.asarray(jpt.y))
    want = [_decode_int(b, curve) for b in blobs]
    assert list(ok) == [w[1] for w in want] == [True, True] + [False] * 6
    assert list(zip(ints(pt.x), ints(pt.y))) == [w[0] for w in want]


def test_decoder_p256_round_trip_vs_ints():
    """P-256, mixed compressed and uncompressed lanes of both parities, the
    invalid forms among them: points and mask against the int decoder; the
    valid lanes encode back to the same bytes."""
    curve = P256
    rng = np.random.default_rng(162)
    pts = _points(curve, rng, 6)
    ours = AffinePoint(tplanes([x for x, _ in pts], 16), tplanes([y for _, y in pts], 16),
                       port_spec(curve))
    comp, unc = encoding.points_to_bytes(ours), encoding.points_to_bytes(ours, False)
    blobs = [comp[0], unc[1], comp[2], unc[3], comp[4], comp[5]] + _invalid_forms(curve, pts[0])
    pt, ok = encoding.points_from_bytes(blobs, port_spec(curve), device="cpu")
    want = [_decode_int(b, curve) for b in blobs]
    assert list(ok) == [w[1] for w in want]
    assert list(zip(ints(pt.x), ints(pt.y))) == [w[0] for w in want]
    assert list(zip(ints(pt.x[:, :6]), ints(pt.y[:, :6]))) == pts
    assert encoding.points_to_bytes(AffinePoint(pt.x[:, :6], pt.y[:, :6], pt.curve)) == [
        comp[i] for i in range(6)]
    # an all-uncompressed batch skips the square root
    pu, oku = encoding.points_from_bytes(unc, port_spec(curve), device="cpu")
    assert list(oku) == [True] * 6 and list(zip(ints(pu.x), ints(pu.y))) == pts
