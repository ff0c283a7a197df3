"""Host-side conversion between Python ints and digit planes.

The port's own copy of the converters of ``ecsimd_tpu/convert.py``: ints,
big-endian bytes and 64-bit limbs to and from digit planes, each on its
numpy path (the JAX package's native packer, ``native/libecpack.so``, is not
the port's and is not loaded): the port imports nothing of the JAX package.
``tests/test_torch_specs.py`` asserts that both give the same arrays.
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


def bytes_be_to_planes(data: bytes, ndigits: int) -> np.ndarray:
    """The concatenation of B fixed-width big-endian values, ``ndigits * 2``
    bytes each -> (D, B) int32 digit planes."""
    width = ndigits * DIGIT_BITS // 8
    assert len(data) % width == 0
    b = np.frombuffer(data, dtype=np.uint8).reshape(-1, width)
    hi = b[:, 0::2].astype(np.int32)
    lo = b[:, 1::2].astype(np.int32)
    digits_be = (hi << 8) | lo  # (B, D) most significant digit first
    return np.ascontiguousarray(digits_be[:, ::-1].T).astype(np.int32)


def u64le_to_planes(limbs) -> np.ndarray:
    """(B, nlimbs) uint64 little-endian limbs -> (4 nlimbs, B) int32 planes:
    each limb splits into four base-2^16 digits."""
    arr = np.ascontiguousarray(limbs, dtype=np.uint64)
    assert arr.ndim == 2, "expected (batch, nlimbs)"
    n, nlimbs = arr.shape
    digs = arr[:, :, None] >> (np.arange(4, dtype=np.uint64) * np.uint64(16))
    return (digs & np.uint64(0xFFFF)).reshape(n, 4 * nlimbs).T.astype(np.int32)


def planes_to_bytes_be(planes) -> bytes:
    """(D, *batch) digit planes -> the lanes' big-endian values, 2 D bytes
    each, concatenated."""
    arr = np.asarray(planes)
    d, b = arr.shape[0], int(np.prod(arr.shape[1:], initial=1))
    digits_be = (arr.astype(np.int64) & DIGIT_MASK).reshape(d, b)[::-1].T  # (B, D) msd first
    out = np.empty((b, d * 2), dtype=np.uint8)
    out[:, 0::2] = (digits_be >> 8).astype(np.uint8)
    out[:, 1::2] = (digits_be & 0xFF).astype(np.uint8)
    return out.tobytes()
