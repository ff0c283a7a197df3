"""SEC1 point encoding: batched octet-string conversion (SEC1 v2 §2.3.3 and
§2.3.4), uncompressed ``04 || X || Y`` and compressed ``02/03 || X`` (the
prefix carries the parity of Y).

The port of ``ecsimd_tpu/encoding.py``. Encoding runs on the host (bytes are
host objects). Decoding parses on the host and runs the field work batched
on the points' device: one ``group.affine_from_x`` decompression over every
lane and one ``ecdh.validate_public`` pass for the lanes that came with an
explicit Y (plain PyTorch; no kernel). Invalid encodings (bad prefix or
length, x >= p, y >= p, x not on the curve, the one-byte infinity 0x00) give
ok = 0 and zeroed coordinates, lane by lane.
"""

from __future__ import annotations

import numpy as np
import torch

from ecsimd_tpu_torch import convert
from ecsimd_tpu_torch.curves import group
from ecsimd_tpu_torch.curves.point import AffinePoint
from ecsimd_tpu_torch.ecdh import validate_public
from ecsimd_tpu_torch.field import GFp
from ecsimd_tpu_torch.ops import bignum as bn
from ecsimd_tpu_torch.specs import CurveSpec


def coordinate_bytes(curve: CurveSpec) -> int:
    """SEC1 field-element octet length ceil(log2 p / 8) (66 for P-521)."""
    return (curve.field.p.bit_length() + 7) // 8


def _lane_bytes(planes: torch.Tensor, length: int) -> np.ndarray:
    """(D, B) classical planes -> (B, length) big-endian bytes of each lane."""
    d = planes.shape[0]
    raw = np.frombuffer(convert.planes_to_bytes_be(planes.cpu().numpy()), dtype=np.uint8)
    return raw.reshape(-1, 2 * d)[:, 2 * d - length:]


def points_to_bytes(points: AffinePoint, compressed: bool = True) -> list[bytes]:
    """Batch of affine points -> SEC1 octet strings (one per lane)."""
    length = coordinate_bytes(points.curve)
    xs = _lane_bytes(points.x, length)
    ys = _lane_bytes(points.y, length)
    if compressed:
        prefix = (0x02 | (ys[:, -1] & 1)).astype(np.uint8)[:, None]
        rows = np.concatenate([prefix, xs], axis=1)
    else:
        prefix = np.full((xs.shape[0], 1), 0x04, dtype=np.uint8)
        rows = np.concatenate([prefix, xs, ys], axis=1)
    return [r.tobytes() for r in rows]


def points_from_bytes(blobs, curve: CurveSpec, device="cuda") -> tuple[AffinePoint, np.ndarray]:
    """SEC1 octet strings -> (AffinePoint batch on ``device``, (B,) bool ok
    mask). Compressed and uncompressed entries may be mixed. Compressed
    lanes decompress through the batched field square root (any odd p:
    ``GFp.sqrt`` dispatches on its kind); uncompressed lanes are held to the
    SP 800-56A partial public-key checks."""
    length = coordinate_bytes(curve)
    p = curve.field.p
    d = curve.field.ndigits
    dev = torch.device(device)

    xs, ys, want_odd, is_comp, host_ok = [], [], [], [], []
    for b in blobs:
        x = y = 0
        odd = comp = ok = False
        if len(b) == 1 + length and b[0] in (0x02, 0x03):
            x = int.from_bytes(b[1:], "big")
            odd, comp, ok = b[0] == 0x03, True, x < p
        elif len(b) == 1 + 2 * length and b[0] == 0x04:
            x = int.from_bytes(b[1:1 + length], "big")
            y = int.from_bytes(b[1 + length:], "big")
            ok = x < p and y < p
        xs.append(x if x < p else 0)
        ys.append(y if y < p else 0)
        want_odd.append(odd)
        is_comp.append(comp)
        host_ok.append(ok)

    x_pl = torch.from_numpy(convert.ints_to_planes(xs, d)).to(dev)
    y_pl = torch.from_numpy(convert.ints_to_planes(ys, d)).to(dev)
    comp_m = torch.from_numpy(np.asarray(is_comp, np.int32)).to(dev)

    if any(is_comp):
        # one batched decompression for every lane (only the compressed ones
        # use it; an all-uncompressed batch skips the square root)
        dec, sqrt_ok = group.affine_from_x(x_pl, curve)
        # SEC1 prefix 03 means Y odd; parity from the classical planes (the
        # internal form may be Montgomery's, whose parity is not the value's)
        ydec = GFp.from_classical(dec.y, curve.field)
        parity = dec.y[0] & 1
        want = torch.from_numpy(np.asarray(want_odd, np.int32)).to(dev)
        y_sel = ydec.select((parity == want).to(torch.int32), ydec.opposite()).to_classical()
    else:
        y_sel = y_pl
        sqrt_ok = torch.zeros(x_pl.shape[1], dtype=torch.int64, device=dev)

    # uncompressed lanes: explicit-Y validation (on the curve, canonical)
    val = validate_public(x_pl, y_pl, curve)

    y_out = bn.select(comp_m, y_sel, y_pl)
    ok_dev = torch.where(comp_m.bool(), sqrt_ok.bool(), val.bool())
    ok = ok_dev.cpu().numpy() & np.asarray(host_ok, bool)
    # zero the coordinates of failed lanes: no garbage leaves the decoder
    okm = torch.from_numpy(ok.astype(np.int32)).to(dev)
    x_out = bn.select(okm, x_pl, torch.zeros_like(x_pl))
    y_out = bn.select(okm, y_out, torch.zeros_like(y_out))
    return AffinePoint(x_out, y_out, curve), ok
