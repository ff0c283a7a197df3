"""Signed fixed-window (w = 4) k_i * P_i: kernel E (``csrc/window.cu`` on
P-256, ``window_<tag>.cu`` on secp256k1, Wei25519, P-384 and P-521), its
wrapper, the recoding and the plain PyTorch version.

Replaces ``ecsimd_tpu/kernels/window.py`` (``window_mont_planes`` and its
Pallas body ``_window_kernel``, both ``strict`` variants). Each lane builds
its own table T[t] = (2t+1) P, t < 8 (one ``dbl_any`` and seven
``jac_add``), seeds the accumulator with P (the recoding's top digit is 1),
then for each 4-bit window, MSB first: four doublings and one add of
+-T[idx] (``jac_add``, or ``add_complete`` when ``strict``). Even scalars get
-P added at the end (``add_z2_1``, or ``add_complete`` when strict): k was
computed as k | 1. The lookup reads all eight entries and keeps one by
masks, and the sign is a masked negation, so nothing is indexed by the
secret digit. ``window_plain`` follows ``_window_core`` operation for
operation; every field result is canonical, so the kernel's Jacobian
planes equal it bit for bit.

On P-384 and P-521 the kernel's per-lane table is split between shared
memory and a scratch in device memory (``table_split``): the wrapper
allocates the scratch, one column for each thread the card holds at once
(``resident_slots``: SMs x the blocks an SM the source's ``_occupancy``
query grants x 64 threads), and the kernel's persistent grid walks the
lanes over those threads.

Scalar domain: non-strict k in [1, order-1) minus the measure-zero class
whose prefix sums collide with a table entry (k = order-2 is one on P-256,
for any P, and not on secp256k1 or Wei25519); strict: all of [1, order).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from ecsimd_tpu_torch.curves import group
from ecsimd_tpu_torch.curves.point import AffinePoint, JacobianPoint
from ecsimd_tpu_torch.field import GFp
from ecsimd_tpu_torch.kernels import _build
from ecsimd_tpu_torch.specs import DIGIT_BITS, P256, P384, P521, CurveSpec

W = 4  # window width in bits
TABLE = 1 << (W - 1)  # odd multiples P, 3P, .., 15P

VEC_BYTES = 16  # the table's unit: one 16-byte vector


@dataclasses.dataclass(frozen=True)
class TableSplit:
    """Kernel E's per-lane table on a wide curve (``csrc/window_table.cuh``,
    ``Split``): the first ``on_chip`` of the eight entries in shared memory,
    the rest in the scratch. An entry's whole 32-bit words (x, y, z) are
    ``vecs`` vectors; P-521's top words (9 bits each) are packed, an
    entry's three into one word, the eight entries' into ``top_vecs``
    vectors kept in shared memory. ``threads`` a block, and the
    ``blocks`` an SM the kernel is built for (``__launch_bounds__``)."""

    on_chip: int
    vecs: int
    top_vecs: int
    threads: int = 64
    blocks: int = 4

    @property
    def smem_bytes(self) -> int:
        """Dynamic shared memory a block."""
        return (self.on_chip * self.vecs + self.top_vecs) * self.threads * VEC_BYTES

    @property
    def scratch_vecs(self) -> int:
        """Vectors a slot (a thread's column) of the scratch."""
        return (TABLE - self.on_chip) * self.vecs

    @property
    def scratch_bytes(self) -> int:
        """Scratch bytes a slot."""
        return self.scratch_vecs * VEC_BYTES


# the split of each wide curve (the sources' kOnChip<TAG>): P-384 12 words,
# 9 vectors an entry; P-521 17 words, 16 whole ones (12 vectors) and the
# packed top word
SPLITS = {P384: TableSplit(on_chip=6, vecs=9, top_vecs=0),
          P521: TableSplit(on_chip=4, vecs=12, top_vecs=2)}


def table_split(curve: CurveSpec) -> TableSplit:
    """Kernel E's table split on ``curve`` (P-384 or P-521)."""
    return SPLITS[curve]


def _kernel(curve: CurveSpec, strict: bool) -> _build.Kernel:
    tag, name = _build.CURVE_TAGS[curve]
    opts = ", ".join(o for o in (name, "strict=True" if strict else None) if o)
    wide = curve in SPLITS  # + the scratch, and its slot count
    return _build.Kernel(
        symbol=f"ec_window_{tag}{'_strict' if strict else ''}",
        source=f"ecsimd_tpu_torch/csrc/{'window.cu' if curve == P256 else f'window_{tag}.cu'}",
        replaces="ecsimd_tpu/kernels/window.py:160 _window_kernel" + (f" ({opts})" if opts else ""),
        n_pointers=7 if wide else 6,
        n_ints=1 if wide else 0,
        n_scratch=1 if wide else 0,
    )


# (curve, strict) -> kernel E instantiation
KERNELS = {(curve, strict): _kernel(curve, strict) for curve in _build.CURVE_TAGS
           for strict in (False, True)}
KERNEL, KERNEL_STRICT = KERNELS[(P256, False)], KERNELS[(P256, True)]

def recode(scalars, curve: CurveSpec):
    """(D, B) scalar planes -> (idx, neg), each (nbits / 4, B) int64, in the
    order the windows run (MSB first). Window i covers bits 4i .. 4i+4 of k
    (bit nbits reads as 0); its signed-odd digit is ((w5 | 1) - 16), of
    magnitude 2 idx + 1 and negative where neg == 1 — the closed form of
    ``oracle/window.recode``."""
    d = curve.field.ndigits
    s = scalars.to(torch.int64)
    zero = torch.zeros_like(s[0])
    idx, neg = [], []
    for dig in range(d - 1, -1, -1):
        plane = s[dig]
        nxt = s[dig + 1] if dig + 1 < d else zero
        for off in range(DIGIT_BITS - W, -1, -W):  # 12, 8, 4, 0
            w5 = plane >> off
            if off:
                w5 = w5 | (nxt << (DIGIT_BITS - off))
            sd = ((w5 & 31) | 1) - 16  # odd, in [-15, 15]
            n = (sd < 0).to(torch.int64)
            idx.append((torch.where(n.bool(), -sd, sd) - 1) >> 1)
            neg.append(n)
    return torch.stack(idx), torch.stack(neg)


def window_plain(scalars, x, y, curve: CurveSpec, strict: bool = False):
    """Plain PyTorch signed window on (D, B) int32 planes: classical scalars
    and internal-domain affine point coordinates (Montgomery form on the
    Montgomery fields, as ``window_mont_planes`` takes them). Returns
    Jacobian (ax, ay, z) internal-domain int32 planes, in the order of
    ``ecsimd_tpu/kernels/window.py:_window_core``."""
    fs = curve.field
    x, y = GFp(x, fs), GFp(y, fs)
    one = x.const_like(1)

    two = group.dbl_any(x, y, one, curve)
    table = [(x, y, one)]
    for _ in range(TABLE - 1):
        table.append(group.jac_add(*table[-1], *two))

    idx, neg = recode(scalars, curve)
    ax, ay, az = x, y, one  # the top digit is 1
    for i in range(idx.shape[0]):
        tx, ty, tz = table[TABLE - 1]
        for t in range(TABLE - 2, -1, -1):  # masked lookup: every entry is read
            m = (idx[i] == t).to(torch.int64)
            ex, ey, ez = table[t]
            tx, ty, tz = ex.select(m, tx), ey.select(m, ty), ez.select(m, tz)
        ty = ty.opposite().select(neg[i], ty)
        for _ in range(W):
            ax, ay, az = group.dbl_any(ax, ay, az, curve)
        if strict:
            ax, ay, az = group.add_complete(ax, ay, az, tx, ty, tz, curve)
        else:
            ax, ay, az = group.jac_add(ax, ay, az, tx, ty, tz)

    opp_y = y.opposite()
    if strict:
        sx, sy, sz = group.add_complete(ax, ay, az, x, opp_y, one, curve)
    else:
        sx, sy, sz = group.add_z2_1(ax, ay, az, x, opp_y)
    meven = 1 - (scalars[0].to(torch.int64) & 1)
    return sx.select(meven, ax).planes, sy.select(meven, ay).planes, sz.select(meven, az).planes


@functools.cache
def occupancy(symbol: str) -> int:
    """The blocks an SM the card holds of kernel ``symbol`` (a wide E), from
    its source's ``<symbol>_occupancy`` query; raises if the query fails or
    grants no block."""
    fn = getattr(_build.library().lib, symbol + "_occupancy")
    fn.argtypes, fn.restype = [], ctypes.c_int
    n = fn()
    if n < 1:
        raise RuntimeError(f"{symbol}: occupancy query gave {n} (minus a CUDA error, or 0)")
    return n


def resident_slots(kernel: _build.Kernel, curve: CurveSpec, device: torch.device) -> int:
    """The scratch's columns for ``kernel`` on ``device``: one for each
    thread the card holds at once (SMs x blocks an SM x threads a block)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return sms * occupancy(kernel.symbol) * table_split(curve).threads


def scratch_for(kernel: _build.Kernel, curve: CurveSpec, device: torch.device) -> torch.Tensor:
    """A wide E's scratch: (scratch_vecs, slots, 4) int32 on ``device``, the
    [vector][slot] layout of 16-byte vectors the kernel takes."""
    shape = (table_split(curve).scratch_vecs, resident_slots(kernel, curve, device), 4)
    return torch.empty(shape, dtype=torch.int32, device=device)


def check_scratch(t: torch.Tensor, curve: CurveSpec, device: torch.device) -> int:
    """Raise unless ``t`` is a contiguous int32 (scratch_vecs, slots, 4)
    tensor on ``device`` with slots a positive multiple of the block's
    threads; return slots."""
    sp = table_split(curve)
    if (t.device != device or t.dtype != torch.int32 or t.dim() != 3
            or t.shape[0] != sp.scratch_vecs or t.shape[2] != 4 or t.shape[1] < 1
            or t.shape[1] % sp.threads or not t.is_contiguous()):
        raise ValueError(f"scratch: expected a contiguous int32 ({sp.scratch_vecs}, slots, 4) "
                         f"tensor on {device}, slots a multiple of {sp.threads}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")
    return t.shape[1]


def window_planes(scalars, x, y, curve: CurveSpec = P256, strict: bool = False):
    """Run kernel E on (D, B) int32 CUDA planes: classical scalars and the
    affine point's coordinates in the field's internal form (as
    ``window_plain``; canonical residues). Returns Jacobian (ax, ay, z)
    internal-form planes. On P-384 and P-521 it allocates the kernel's
    scratch (``scratch_for``)."""
    _build.require_cuda(scalars, "window")
    kernel = KERNELS.get((curve, bool(strict)))
    if kernel is None:
        raise NotImplementedError(
            f"{curve.name}: the CUDA window covers P-256, secp256k1, Wei25519, P-384 and P-521")
    shape = (curve.field.ndigits, scalars.shape[-1])
    for name, t in (("scalars", scalars), ("x", x), ("y", y)):
        _build.check_planes(name, t, shape, scalars.device)
    ax, ay, z = (torch.empty(shape, dtype=torch.int32, device=scalars.device) for _ in range(3))
    if curve in SPLITS:
        scratch = scratch_for(kernel, curve, scalars.device)
        slots = check_scratch(scratch, curve, scalars.device)
        _build.launch(kernel, [scalars, x, y, ax, ay, z, scratch], shape[1], slots)
    else:
        _build.launch(kernel, [scalars, x, y, ax, ay, z], shape[1])
    kernel.count(shape[1])
    return ax, ay, z


def scalar_mult(scalars, pt: AffinePoint, strict: bool = False) -> JacobianPoint:
    """k_i * P_i for an affine batch (classical planes, converted to the
    field's internal domain here): kernel E for CUDA tensors,
    ``window_plain`` for CPU tensors. Returns Jacobian internal-domain
    planes."""
    curve = pt.curve
    fs = curve.field
    xm = GFp.from_classical(pt.x, fs).planes.contiguous()
    ym = GFp.from_classical(pt.y, fs).planes.contiguous()
    args = (scalars.contiguous(), xm, ym, curve)
    if scalars.device.type == "cpu":
        ax, ay, z = window_plain(*args, strict=strict)
    else:
        ax, ay, z = window_planes(*args, strict=strict)
    return JacobianPoint(GFp(ax, fs), GFp(ay, fs), GFp(z, fs), curve)
