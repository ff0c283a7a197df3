"""Host-side conversion between Python ints and digit planes.

The port's own copy of the int converters of ``ecsimd_tpu/convert.py``
(numpy path; the byte and limb packers come with the paths that need them):
the port imports nothing of the JAX package. ``tests/test_torch_specs.py``
asserts that both give the same arrays.
"""

from __future__ import annotations

import numpy as np

from ecsimd_tpu_torch.specs import DIGIT_BITS, DIGIT_MASK


def ints_to_planes(values, ndigits: int) -> np.ndarray:
    """Python ints -> (D, B) int32 digit planes (little-endian digits), through
    one bytes object of 16-bit digits (a per-digit loop takes seconds at
    hundreds of thousands of lanes)."""
    values = [int(v) for v in values]
    for v in values:
        assert 0 <= v < (1 << (ndigits * DIGIT_BITS)), "value out of range"
    raw = b"".join(v.to_bytes(ndigits * DIGIT_BITS // 8, "little") for v in values)
    digits = np.frombuffer(raw, dtype="<u2").reshape(len(values), ndigits)
    return np.ascontiguousarray(digits.T, dtype=np.int32)


def planes_to_ints(planes) -> list[int]:
    """(D, B) digit planes -> list of B Python ints."""
    planes = np.asarray(planes)
    d = planes.shape[0]
    flat = planes.reshape(d, -1)
    out = []
    for j in range(flat.shape[1]):
        v = 0
        for k in range(d):
            v |= (int(flat[k, j]) & DIGIT_MASK) << (k * DIGIT_BITS)
        out.append(v)
    return out


def broadcast_int(value: int, ndigits: int, batch: int) -> np.ndarray:
    """One value replicated across the batch."""
    return np.repeat(ints_to_planes([value], ndigits), batch, axis=1)
