"""The x-only Montgomery ladder (RFC 7748 X25519 class): kernel G
(``csrc/mladder.cu``), kernel H (x / z, same source), their wrappers and
their plain PyTorch versions.

Replaces ``ecsimd_tpu/kernels/mladder.py`` (``mladder_planes`` and its
Pallas body ``_mladder_kernel``, core ``_mladder_core``). ``mladder_plain``
follows ``_mladder_core`` operation for operation: per bit, the deferred
conditional swap on swap ^ k_t, then the 5M + 4S + 1 a24 step of RFC 7748
§5, and the final swap. Every field result is canonical, so kernel G's
projective (x2, z2) planes equal it bit for bit.

Kernel H forms x2 / z2 per lane (x2 z2^(p-2), the 2^255 - 19 addition
chain) where the JAX package shares one inversion across the batch
(``GFp.batch_inverse``, ``ecsimd_tpu/x25519.py``); ``xdivz_plain`` is that
batch inversion. z2 = 0 (a low-order u) gives 0 in both.

Each wrapper runs its kernel for CUDA tensors and its plain version for
CPU tensors. The kernels cover X25519's instance: the 2^255 - 19 field,
a24 = 121665 and 255 scanned bits; other instances run on the CPU only.
"""

from __future__ import annotations

import torch

from ecsimd_tpu_torch.field import GFp
from ecsimd_tpu_torch.kernels import _build
from ecsimd_tpu_torch.specs import DIGIT_BITS, W25519_FIELD, FieldSpec

I64 = torch.int64
A24 = 121665  # (486662 - 2) / 4, RFC 7748 §5
NBITS_SCAN = 255  # a clamped X25519 scalar's bits 254..0

KERNEL = _build.Kernel(
    symbol="ec_mladder_w25519",
    source="ecsimd_tpu_torch/csrc/mladder.cu",
    replaces="ecsimd_tpu/kernels/mladder.py:81 _mladder_kernel",
    n_pointers=4,
)
KERNEL_XDIVZ = _build.Kernel(
    symbol="ec_xdivz_w25519",
    source="ecsimd_tpu_torch/csrc/mladder.cu",
    replaces="ecsimd_tpu/x25519.py:88 GFp.batch_inverse of x2 / z2 (XLA, no Pallas kernel)",
    n_pointers=3,
)


def _bit_at(scalars, i: int):
    """Bit i of each lane's scalar, as ``_mladder_core.bit_at`` reads it."""
    digit, off = divmod(i, DIGIT_BITS)
    return (scalars[digit].to(I64) >> off) & 1


def mladder_plain(scalars, u, fs: FieldSpec, a24: int, nbits_scan: int):
    """Plain PyTorch x-only ladder on (D, B) planes: scalars (caller-clamped)
    and u in [0, p). Scans bits nbits_scan - 1 .. 0 and returns the
    projective (x2, z2) int32 planes."""
    assert fs.plain, "x-only ladder: plain-domain fields only"
    x1 = GFp(u, fs)
    one = GFp.one(fs, u)
    a24c = x1.const_like(a24)
    x2, z2, x3, z3 = one, x1.const_like(0), x1, one
    swap = torch.zeros(u.shape[1:], dtype=I64, device=u.device)
    for t in range(nbits_scan):
        kt = _bit_at(scalars, nbits_scan - 1 - t)
        sw = swap ^ kt
        x2, x3 = x3.select(sw, x2), x2.select(sw, x3)
        z2, z3 = z3.select(sw, z2), z2.select(sw, z3)
        a = x2 + z2
        aa = a.sqr()
        b = x2 - z2
        bb = b.sqr()
        e = aa - bb
        c = x3 + z3
        d = x3 - z3
        da = d * a
        cb = c * b
        x3 = (da + cb).sqr()
        z3 = x1 * (da - cb).sqr()
        x2 = aa * bb
        z2 = e * (aa + a24c * e)
        swap = kt
    return x3.select(swap, x2).planes, z3.select(swap, z2).planes


def _check_instance(fs: FieldSpec, a24: int, nbits_scan: int):
    if (fs, a24, nbits_scan) != (W25519_FIELD, A24, NBITS_SCAN):
        raise NotImplementedError(
            f"kernel G runs X25519's ladder (w25519, a24 = {A24}, {NBITS_SCAN} bits); got "
            f"({fs.name}, {a24}, {nbits_scan}): use CPU tensors for other instances"
        )


def mladder_planes(scalars, u, fs: FieldSpec, a24: int, nbits_scan: int):
    """(x2, z2) projective planes of the x-only ladder, the JAX
    ``mladder_planes`` contract: kernel G for CUDA tensors, ``mladder_plain``
    for CPU tensors. Plain-domain fields only; u must be canonical (< p)."""
    assert fs.plain, "x-only ladder: plain-domain fields only"
    if scalars.device.type == "cpu":
        return mladder_plain(scalars, u, fs, a24, nbits_scan)
    _build.require_cuda(scalars, "mladder")
    _check_instance(fs, a24, nbits_scan)
    shape = (fs.ndigits, scalars.shape[-1])
    scalars, u = scalars.contiguous(), u.contiguous()
    _build.check_planes("scalars", scalars, shape, scalars.device)
    _build.check_planes("u", u, shape, scalars.device)
    x2, z2 = (torch.empty(shape, dtype=torch.int32, device=scalars.device) for _ in range(2))
    _build.launch(KERNEL, [scalars, u, x2, z2], shape[1])
    KERNEL.count(shape[1])
    return x2, z2


def xdivz_plain(x2, z2, fs: FieldSpec):
    """x2 / z2 per lane through one batch inversion (the JAX package's
    X25519 epilogue); lanes with z2 = 0 give 0. Plain-domain planes."""
    return (GFp(x2, fs) * GFp(z2, fs).batch_inverse()).planes


def xdivz(x2, z2, fs: FieldSpec = W25519_FIELD):
    """x2 / z2: kernel H for CUDA tensors, ``xdivz_plain`` for CPU tensors."""
    if x2.device.type == "cpu":
        return xdivz_plain(x2, z2, fs)
    _build.require_cuda(x2, "xdivz")
    if fs != W25519_FIELD:
        raise NotImplementedError(f"{fs.name}: kernel H covers the 2^255 - 19 field only")
    shape = (fs.ndigits, x2.shape[-1])
    x2, z2 = x2.contiguous(), z2.contiguous()
    _build.check_planes("x2", x2, shape, x2.device)
    _build.check_planes("z2", z2, shape, x2.device)
    out = torch.empty(shape, dtype=torch.int32, device=x2.device)
    _build.launch(KERNEL_XDIVZ, [x2, z2, out], shape[1])
    KERNEL_XDIVZ.count(shape[1])
    return out
