"""The reduction tree of multi-scalar multiplication: kernel M
(``csrc/batch_sum.cu`` on P-256, secp256k1 and Wei25519,
``csrc/batch_sum_p384.cu`` and ``batch_sum_p521.cu``) and its wrapper.

The JAX package sums a batch with plain XLA (``ecsimd_tpu/curves/group.py``
``batch_sum``: log2 B levels of the complete add, no Pallas kernel). The
plain PyTorch version is this package's ``group.batch_sum``; on the card
each of its levels is ~30 field operations of many small launches, so kernel
M runs a whole tree in one cooperative launch: output lane i of a level =
lane i + lane i + n // 2, an odd last lane carried, the JAX package's tree
and formulas, the levels separated by a grid sync while they fill the card
and finished by one block once a level fits it (``batch_sum_lane.cuh``'s
``batch_sum_tree``). Every field result is canonical, so the two agree bit
for bit, the output's Jacobian representative included.
"""

from __future__ import annotations

import ctypes

import torch

from ecsimd_tpu_torch.curves import group
from ecsimd_tpu_torch.curves.point import JacobianPoint
from ecsimd_tpu_torch.field import GFp
from ecsimd_tpu_torch.kernels import _build
from ecsimd_tpu_torch.specs import CurveSpec

# Threads a block of kernel M on every curve, batch_sum_kernel.cuh's
# batch_sum::kThreads: a level whose output has at most THREADS lanes runs in
# block 0 alone.
THREADS = 128

KERNELS = {}
for _curve in _build.CURVES:
    _tag, _name = _build.CURVE_TAGS[_curve]
    _source = "batch_sum.cu" if _curve in _build.CURVES_256 else f"batch_sum_{_tag}.cu"
    KERNELS[_curve] = _build.Kernel(
        symbol=f"ec_batch_sum_{_tag}",
        source=f"ecsimd_tpu_torch/csrc/{_source}",
        replaces="ecsimd_tpu/curves/group.py:367 batch_sum" + (
            f" ({_name}; XLA, no Pallas kernel)" if _name else " (XLA, no Pallas kernel)"),
        n_pointers=7, n_ints=1, n_scratch=1,
    )


def depth(n: int) -> int:
    """The levels of a whole tree over ``n`` lanes, ceil(log2 n)."""
    return (n - 1).bit_length()


def lanes_after(n: int, levels: int) -> int:
    """The lanes left after ``levels`` levels over ``n`` lanes."""
    for _ in range(levels):
        n -= n // 2
    return n


def scratch_lanes(n: int) -> int:
    """The lanes of the kernel's two ping-pong buffers over ``n`` lanes
    together: ceil(n / 2) for the even levels, half that for the odd ones."""
    h0 = n - n // 2
    return h0 + (h0 - h0 // 2)


def blocks_per_sm(curve: CurveSpec) -> int:
    """The blocks of ``THREADS`` threads an SM holds of ``curve``'s kernel M,
    from its source's ``_blocks`` occupancy query (builds the library; needs
    the card)."""
    fn = getattr(_build.library().lib, f"{KERNELS[curve].symbol}_blocks")
    fn.argtypes, fn.restype = [], ctypes.c_int
    blocks = fn()
    if blocks <= 0:
        raise RuntimeError(f"{KERNELS[curve].symbol}: the occupancy query gave {blocks}")
    return blocks


def tree_planes(x, y, z, curve: CurveSpec, levels: int | None = None):
    """One launch of kernel M on (D, n) int32 CUDA Jacobian planes (internal
    form), n >= 2: the first ``levels`` levels of the tree (default: all,
    ceil(log2 n)), returning the (D, lanes_after(n, levels)) planes left."""
    _build.require_cuda(x, "batch_sum")
    kernel = KERNELS.get(curve)
    if kernel is None:
        raise NotImplementedError(
            f"{curve.name}: the CUDA batch sum covers P-256, secp256k1, Wei25519, P-384 and "
            "P-521")
    d, n = curve.field.ndigits, x.shape[-1]
    if n < 2:
        raise ValueError(f"batch_sum: a tree takes at least 2 lanes, got {n}")
    levels = depth(n) if levels is None else levels
    if not 1 <= levels <= depth(n):
        raise ValueError(f"batch_sum: {n} lanes take 1 to {depth(n)} levels, got {levels}")
    for name, t in (("x", x), ("y", y), ("z", z)):
        _build.check_planes(name, t, (d, n), x.device)
    m = lanes_after(n, levels)
    out = [torch.empty((d, m), dtype=torch.int32, device=x.device) for _ in range(3)]
    scratch = torch.empty(3 * d * scratch_lanes(n) if levels > 1 else 0, dtype=torch.int32,
                          device=x.device)
    _build.launch(kernel, [x, y, z, *out, scratch], n, levels)
    kernel.count(n, levels)
    return tuple(out)


def level_planes(x, y, z, curve: CurveSpec):
    """One level of kernel M (``levels`` = 1): (D, n) planes, n >= 2 -> the
    next level's (D, (n + 1) // 2) planes."""
    return tree_planes(x, y, z, curve, levels=1)


def batch_sum_planes(x, y, z, curve: CurveSpec):
    """A whole tree in one launch of kernel M: (D, n) Jacobian planes -> the
    (D, 1) planes of their sum (a 1-lane batch as it is)."""
    if x.shape[-1] == 1:
        return x, y, z
    return tree_planes(x, y, z, curve)


def batch_sum(pt: JacobianPoint) -> JacobianPoint:
    """The sum of a flat (D, B) Jacobian batch as a 1-lane batch (it may be
    the point at infinity, z = 0): kernel M for CUDA tensors, the plain
    ``group.batch_sum`` for CPU tensors."""
    if pt.x.planes.device.type == "cpu":
        return group.batch_sum(pt)
    if pt.x.planes.ndim != 2:
        raise ValueError("batch_sum expects flat (D, B) planes")
    fs = pt.curve.field
    x, y, z = batch_sum_planes(pt.x.planes.contiguous(), pt.y.planes.contiguous(),
                               pt.z.planes.contiguous(), pt.curve)
    return JacobianPoint(GFp(x, fs), GFp(y, fs), GFp(z, fs), pt.curve)
