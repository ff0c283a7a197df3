"""RFC 7748 X25519 — batched x-only Montgomery ladder over 2^255 - 19, the
port of ``ecsimd_tpu/x25519.py``.

* ``x25519_planes``: the exchange. u is reduced once below p, then the
  x-only ladder (kernel G on the card) gives projective (x2, z2), and
  x2 / z2 (kernel H on the card: a per-lane inversion; on the CPU one
  batch inversion, as the JAX package's XLA path) gives the output u.
  The ladder needs no y and accepts u on the curve and on its twist, as
  RFC 7748 §5 requires.
* ``derive_public_planes`` / ``derive_public_batch``: keygen X25519(k, 9)
  through the fixed-base comb on Wei25519, the Weierstrass lift of
  Curve25519 (kernel B, then kernel D), then u = x - A/3 as a field
  operation on the tensors' device. Clamped scalars sit near 2^254, above
  the subgroup order; the comb is defined over the full 256-bit range.

Byte-level calls follow the RFC's conventions: 32-byte little-endian
strings, the top bit of u masked, scalars clamped. Entry points that make
tensors run on the card unless the caller passes ``device="cpu"``; the
planes functions run on the device of their input tensors. The JAX
package's ``use_kernel``, ``tile`` and ``interpret`` are not ported: the
device picks the route.
"""

from __future__ import annotations

import numpy as np
import torch

from ecsimd_tpu_torch.field import GFp
from ecsimd_tpu_torch.kernels import affine, comb, mladder
from ecsimd_tpu_torch.ops import bignum as bn
from ecsimd_tpu_torch.ops import mont
from ecsimd_tpu_torch.specs import W25519_FIELD, WEI25519

A24 = mladder.A24  # (486662 - 2) / 4
MONT_A = 486662
# u = x - A/3 maps a Wei25519 x back to Curve25519's u
A_OVER_3 = MONT_A * pow(3, -1, W25519_FIELD.p) % W25519_FIELD.p


def clamp(k_bytes: bytes) -> int:
    """RFC 7748 §5 decodeScalar25519."""
    k = bytearray(k_bytes)
    k[0] &= 248
    k[31] &= 127
    k[31] |= 64
    return int.from_bytes(bytes(k), "little")


def decode_u(u_bytes: bytes) -> int:
    """RFC 7748 §5 decodeUCoordinate: mask the unused top bit. The value is
    not reduced mod p here; ``x25519_planes`` reduces it."""
    u = bytearray(u_bytes)
    u[31] &= 127
    return int.from_bytes(bytes(u), "little")


def reduce_u(u_planes):
    """Masked u planes (< 2^255) -> u mod p: u in [p, 2^255) is reduced
    once, as both JAX paths do before the ladder."""
    u64 = u_planes.to(torch.int64)
    return bn.sub_if_above(u64, mont.p_planes(W25519_FIELD, u64).expand_as(u64)).to(torch.int32)


def x25519_planes(k_planes, u_planes):
    """Batched X25519 on (16, B) int32 digit planes: clamped scalars and
    masked u-coordinates (< 2^255). Returns the output u planes; a
    low-order u gives 0 (the all-zero secret RFC callers check for)."""
    fs = W25519_FIELD
    x2, z2 = mladder.mladder_planes(k_planes, reduce_u(u_planes), fs, A24, mladder.NBITS_SCAN)
    return mladder.xdivz(x2, z2, fs)


def derive_public_planes(k_planes):
    """Public keys X25519(k, 9) of clamped scalar planes, as u planes: comb
    on Wei25519, affine conversion, u = x - A/3."""
    aff = affine.to_affine(comb.scalar_mult_base(k_planes, WEI25519))
    x = GFp(aff.x, W25519_FIELD)
    return (x - x.const_like(A_OVER_3)).planes


def _byte_planes(strings: list[bytes], scalars: bool, device):
    """32-byte little-endian strings -> (16, B) int32 digit planes on
    ``device``, clamped (``scalars``) or with u's top bit masked: the
    bytes of a lane are its 16 base-2^16 digits, so this is a reshape,
    vectorised over the batch (``clamp`` / ``decode_u`` per value)."""
    if any(len(s) != 32 for s in strings):
        raise ValueError("X25519 keys and u-coordinates are 32 bytes each")
    arr = np.frombuffer(b"".join(strings), dtype=np.uint8).reshape(-1, 32).copy()
    if scalars:
        arr[:, 0] &= 248
        arr[:, 31] &= 127
        arr[:, 31] |= 64
    else:
        arr[:, 31] &= 127
    planes = np.ascontiguousarray(arr.view("<u2").T).astype(np.int32)
    return torch.from_numpy(planes).to(torch.device(device))


def _bytes(planes) -> list[bytes]:
    """(16, B) digit planes -> B 32-byte little-endian strings."""
    data = np.ascontiguousarray(planes.cpu().numpy().T).astype("<u2").tobytes()
    return [data[i : i + 32] for i in range(0, len(data), 32)]


def derive_public_batch(ks: list[bytes], device="cuda") -> list[bytes]:
    """Batched X25519 public-key derivation from 32-byte private keys."""
    return _bytes(derive_public_planes(_byte_planes(ks, True, device)))


def x25519_batch(ks: list[bytes], us: list[bytes], device="cuda") -> list[bytes]:
    """Batched RFC 7748 X25519(k, u) on raw 32-byte strings."""
    return _bytes(x25519_planes(_byte_planes(ks, True, device), _byte_planes(us, False, device)))


def x25519(k: bytes, u: bytes, device="cuda") -> bytes:
    return x25519_batch([k], [u], device)[0]
