"""Fixed-base comb k_i * B: kernel B (``csrc/comb.cu``, P-256, secp256k1
and, non-strict, Wei25519), its wrapper, its plain PyTorch version and the
host-built tables.

Replaces ``ecsimd_tpu/kernels/comb.py`` (``comb_mont_planes`` with
``chain="serial"`` and its Pallas body ``_comb_kernel``). The tables are
built once on the host with Python ints for the shared base: entry e of
position i >= 1 holds the affine (2e - 255) * 2^(8i) * B, and position 0
additionally folds in the recoding's constant top digit, so the scalar
multiplication is 31 mixed additions and no doublings (``strict``: 31
complete adds, ``group.jac_add_complete``, each with one doubling computed
beside it). ``_batch_inv``,
``_to_internal`` and ``base_tables`` are copies of the JAX package's
pure-Python ones (a test asserts equal output); ``entry_indices`` and
``comb_plain`` are PyTorch ports of ``entry_indices`` and
``comb_xla_planes``, and ``comb_plain`` is the kernel's plain version.

Scalar domain: k in [1, order-1), minus the measure-zero degenerate class
of scalars whose prefix sums collide with a table entry's x line
(``ecsimd_tpu/kernels/comb.py`` docstring); ``strict``: all of [1, order),
k = order - 1 included (its chain ends at infinity and the fix-up resolves
inf + (-B) = -B).

Kernel B reads no table word at an address that depends on the scalar, as
the TPU kernel's one-hot read of the whole position does not: the block
stages each position in shared memory and every lane scans all of it with
masks. Its table layout (``kernel_tables``) keeps a position's entries as
32-bit limbs, and only the positive half of positions 1..31 (the sign is a
masked negation). ``comb_plain`` keeps the indexed gather: it is the
comparator, and runs on the main path only for CPU tensors.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ecsimd_tpu_torch.curves import group
from ecsimd_tpu_torch.curves.point import JacobianPoint
from ecsimd_tpu_torch.field import GFp
from ecsimd_tpu_torch.kernels import _build
from ecsimd_tpu_torch.oracle import window as ow
from ecsimd_tpu_torch.specs import DIGIT_BITS, P256, SECP256K1, WEI25519, CurveSpec, int_to_digits

W = 8  # window width in bits; 2^(W-1) signed-odd magnitudes per position
NENT = 1 << W  # table entries per position: d = 2e - (2^W - 1), e in [0, 2^W)

KERNEL = _build.Kernel(
    symbol="ec_comb_p256",
    source="ecsimd_tpu_torch/csrc/comb.cu",
    replaces="ecsimd_tpu/kernels/comb.py:213 _comb_kernel",
    n_pointers=6,
)
KERNEL_STRICT = _build.Kernel(
    symbol="ec_comb_p256_strict",
    source="ecsimd_tpu_torch/csrc/comb.cu",
    replaces="ecsimd_tpu/kernels/comb.py:213 _comb_kernel (strict=True)",
    n_pointers=6,
)
KERNEL_SECP256K1 = _build.Kernel(
    symbol="ec_comb_secp256k1",
    source="ecsimd_tpu_torch/csrc/comb.cu",
    replaces="ecsimd_tpu/kernels/comb.py:213 _comb_kernel (secp256k1)",
    n_pointers=6,
)
KERNEL_SECP256K1_STRICT = _build.Kernel(
    symbol="ec_comb_secp256k1_strict",
    source="ecsimd_tpu_torch/csrc/comb.cu",
    replaces="ecsimd_tpu/kernels/comb.py:213 _comb_kernel (secp256k1, strict=True)",
    n_pointers=6,
)
KERNEL_W25519 = _build.Kernel(
    symbol="ec_comb_w25519",
    source="ecsimd_tpu_torch/csrc/comb.cu",
    replaces="ecsimd_tpu/kernels/comb.py:213 _comb_kernel (Wei25519, X25519 keygen)",
    n_pointers=6,
)
# (curve, strict) -> kernel B instantiation
KERNELS = {
    (P256, False): KERNEL, (P256, True): KERNEL_STRICT,
    (SECP256K1, False): KERNEL_SECP256K1, (SECP256K1, True): KERNEL_SECP256K1_STRICT,
    (WEI25519, False): KERNEL_W25519,
}


def _npos(nbits: int) -> int:
    assert nbits % W == 0
    return nbits // W


# --- host tables (copied from ecsimd_tpu/kernels/comb.py) -------------------------


def _batch_inv(zs: list[int], p: int) -> list[int]:
    """Montgomery's trick: n inversions for one pow + 3n mults."""
    pref = [1]
    for z in zs:
        pref.append(pref[-1] * z % p)
    inv = pow(pref[-1], p - 2, p)
    out = [0] * len(zs)
    for i in range(len(zs) - 1, -1, -1):
        out[i] = inv * pref[i] % p
        inv = inv * zs[i] % p
    return out


def _to_internal(v: int, fs) -> int:
    return v % fs.p if fs.plain else (v << fs.nbits) % fs.p


@functools.cache
def base_tables(curve: CurveSpec, bx: int, by: int):
    """Host-precomputed comb tables for base B = (bx, by).

    Returns (tables, negbase):
      tables: (npos, 256, 2*d) int32 — internal-domain digit rows, entry e of
              position i >= 1 holding affine (x, y) of (2e - 255) * 2^(8i) * B;
              position 0 additionally folds in the recoding's constant top
              digit: entry e holds affine of (2^nbits + (2e - 255)) * B, so
              the accumulator seeds directly from the position-0 gather
              (z = 1) and the chain is one add per position with no
              special init step;
      negbase: classical affine (x, y) of -B (parity fixup operand).
    """
    fs = curve.field
    p, d = fs.p, fs.ndigits
    npos = _npos(fs.nbits)

    base = (bx, by, 1)
    jacs = []  # (npos, 128) Jacobian odd multiples, magnitude order 1,3,..,255
    for i in range(npos):
        two = ow._jac_dbl(base, curve)
        row = [base]
        for _ in range(NENT // 2 - 1):
            row.append(ow._jac_add(row[-1], two, curve))
        jacs.append(row)
        base = two
        for _ in range(W - 1):  # base *= 2^W total per position
            base = ow._jac_dbl(base, curve)
    top_jac = base  # 2^(8*npos) * B = 2^nbits * B

    # position 0: signed entries with top folded in, (2^nbits +- (2m+1)) * B
    # (never infinity/degenerate: |2^nbits mod order| >> 255 for any real
    # curve — the top digit and a window digit cannot cancel)
    pos0 = []
    for m in range(NENT // 2):
        x, y, z = jacs[0][m]
        pos0.append(ow._jac_add(top_jac, (x, y, z), curve))
        pos0.append(ow._jac_add(top_jac, (x, (p - y) % p, z), curve))

    flat = [pt for row in jacs[1:] for pt in row] + pos0
    zinv = _batch_inv([z for _, _, z in flat], p)
    aff = []
    for (x, y, _), zi in zip(flat, zinv):
        zi2 = zi * zi % p
        aff.append((x * zi2 % p, y * zi2 % p * zi % p))

    tables = np.zeros((npos, NENT, 2 * d), np.int32)

    def put(i, e, ax, ay):
        tables[i, e, :d] = int_to_digits(_to_internal(ax, fs), d)
        tables[i, e, d:] = int_to_digits(_to_internal(ay, fs), d)

    for i in range(1, npos):
        for m in range(NENT // 2):  # magnitude 2m+1
            ax, ay = aff[(i - 1) * (NENT // 2) + m]
            put(i, (NENT - 1 + (2 * m + 1)) // 2, ax, ay)  # +d entry
            put(i, (NENT - 1 - (2 * m + 1)) // 2, ax, (p - ay) % p)  # -d
    off = (npos - 1) * (NENT // 2)
    for m in range(NENT // 2):
        px, py = aff[off + 2 * m]  # top + (2m+1) B
        nx, ny = aff[off + 2 * m + 1]  # top - (2m+1) B
        put(0, (NENT - 1 + (2 * m + 1)) // 2, px, py)
        put(0, (NENT - 1 - (2 * m + 1)) // 2, nx, ny)
    tables.setflags(write=False)  # cached + shared by every caller
    return tables, (bx, (p - by) % p)


def tables_from_numpy(np_tables, device) -> torch.Tensor:
    """A (npos, 256, 2D) int32 numpy table — this module's ``base_tables``
    or the JAX package's ``ecsimd_tpu.kernels.comb.base_tables(...)[0]`` —
    as a contiguous int32 tensor on ``device`` (a copy)."""
    arr = np.asarray(np_tables)
    if arr.dtype != np.int32 or arr.ndim != 3 or arr.shape[1] != NENT:
        raise ValueError(f"expected int32 (npos, {NENT}, 2D) tables, got {arr.dtype} {arr.shape}")
    return torch.tensor(arr, dtype=torch.int32, device=device)


@functools.cache
def device_tables(curve: CurveSpec, bx: int, by: int, device: torch.device):
    """(tables, negbase, negbase_digits) on ``device``, built once per
    (curve, base, device): the comb's one piece of carried state. The
    negbase digits are the 2D int32 internal-domain digits of -B's x then y,
    as kernel B reads them."""
    tables, negbase = base_tables(curve, bx, by)
    fs = curve.field
    nb = np.concatenate([int_to_digits(_to_internal(v, fs), fs.ndigits) for v in negbase])
    return (
        tables_from_numpy(tables, device),
        negbase,
        torch.tensor(nb, dtype=torch.int32, device=device),
    )


def limb_layout(np_tables):
    """Kernel B's table layout from (npos, 256, 2D) int32 digit tables:
    (256 + (npos - 1) * 128, D) int32 rows, one per kept entry, each the
    D/2 32-bit limbs of x then of y. Position 0 keeps its 256 entries;
    positions 1..npos-1 keep entries 128..255, the positive multiples
    (2m+1) 2^(8i) B in magnitude order (entry 127 - m is their opposite)."""
    t = np.asarray(np_tables).astype(np.int64)
    d = t.shape[2] // 2
    limbs = (t[..., 0::2] & 0xFFFF) | (t[..., 1::2] << DIGIT_BITS)
    rows = np.concatenate([limbs[0], limbs[1:, NENT // 2 :].reshape(-1, d)])
    return rows.astype(np.uint32).view(np.int32)


@functools.cache
def kernel_tables(curve: CurveSpec, bx: int, by: int, device: torch.device) -> torch.Tensor:
    """``limb_layout`` of the base's tables on ``device``, built once per
    (curve, base, device)."""
    return torch.tensor(limb_layout(base_tables(curve, bx, by)[0]), device=device)


# --- entry indices and the plain comb ---------------------------------------------


def entry_indices(scalars, curve: CurveSpec):
    """(D, B) scalar planes -> (npos, B) int64 table entry indices
    e_i = w9_i >> 1, where w9_i is the 9-bit window k[8i .. 8i+8] (signed-odd
    recoding with the sign/odd-forcing folded into the table layout).
    Digits are nonnegative, so torch's arithmetic shifts are logical here."""
    fs = curve.field
    d = fs.ndigits
    s = scalars.to(torch.int64)
    idx = []
    for i in range(_npos(fs.nbits)):
        j, off = divmod(W * i, DIGIT_BITS)
        w = s[j] >> off
        if off + W + 1 > DIGIT_BITS and j + 1 < d:
            w = w | (s[j + 1] << (DIGIT_BITS - off))
        idx.append((w & (2 * NENT - 1)) >> 1)
    return torch.stack(idx)


def comb_plain(scalars, tables, curve: CurveSpec, negbase, strict: bool = False):
    """Plain PyTorch comb on (D, B) planes, in the order of the JAX
    package's ``comb_xla_planes``: seed from the position-0 entry with
    z = 1, one ADD_Z2_1 per position 1..npos-1, then add -B on even lanes.
    ``strict`` replaces every add with ``group.jac_add_complete`` against
    the entry with z = 1. Returns Jacobian (ax, ay, z) int32 planes."""
    fs = curve.field
    d = fs.ndigits
    idx = entry_indices(scalars, curve)

    def entry(i):
        e = tables[i][idx[i]].t()  # (2d, B)
        return GFp(e[:d], fs), GFp(e[d:], fs)

    def add(x, y, z, ex, ey):
        if not strict:
            return group.add_z2_1(x, y, z, ex, ey)
        p = group.jac_add_complete(
            JacobianPoint(x, y, z, curve), JacobianPoint(ex, ey, ex.const_like(1), curve))
        return p.x, p.y, p.z

    x, y = entry(0)
    z = GFp.one(fs, x.planes)
    for i in range(1, _npos(fs.nbits)):
        x, y, z = add(x, y, z, *entry(i))

    sx, sy, sz = add(x, y, z, x.const_like(negbase[0]), x.const_like(negbase[1]))
    meven = 1 - (scalars[0] & 1)
    return sx.select(meven, x).planes, sy.select(meven, y).planes, sz.select(meven, z).planes


def comb_planes(scalars, tables, negbase_digits, curve: CurveSpec = P256, strict: bool = False):
    """Run kernel B (``strict``: its complete-add instantiation) on (D, B)
    int32 CUDA scalar planes with ``kernel_tables`` and the negbase digits
    of ``device_tables``. Returns Jacobian (ax, ay, z) planes (internal
    domain)."""
    _build.require_cuda(scalars, "comb")
    kernel = KERNELS.get((curve, strict))
    if kernel is None:
        raise NotImplementedError(
            f"{curve.name} (strict={strict}): the CUDA comb covers P-256 and secp256k1, both "
            "modes, and Wei25519 non-strict (ROADMAP B0, other fields)"
        )
    d = curve.field.ndigits
    shape = (d, scalars.shape[-1])
    dev = scalars.device
    npos = _npos(curve.field.nbits)
    _build.check_planes("scalars", scalars, shape, dev)
    _build.check_planes("tables", tables, (NENT + (npos - 1) * NENT // 2, d), dev)
    _build.check_planes("negbase", negbase_digits, (2 * d,), dev)
    if tables.data_ptr() % 16:
        raise ValueError("tables: kernel B stages entries as 16-byte words; need 16-byte alignment")
    ax, ay, z = (torch.empty(shape, dtype=torch.int32, device=dev) for _ in range(3))
    _build.launch(kernel, [scalars, tables, negbase_digits, ax, ay, z], shape[1])
    kernel.launches += 1
    return ax, ay, z


def scalar_mult_base(
    scalars, curve: CurveSpec = P256, base: tuple[int, int] | None = None,
    strict: bool = False, chains: int = 1, unroll: int = 1,
) -> JacobianPoint:
    """k_i * B for a base shared by every lane (default: the generator).

    scalars: (D, B) classical digit planes. Kernel B for CUDA tensors,
    ``comb_plain`` for CPU tensors. ``strict`` uses complete additions
    (scalar domain [1, order)). ``chains`` (independent accumulators) and
    ``unroll`` are the JAX package's options; neither is ported yet."""
    if chains != 1 or unroll != 1:
        raise NotImplementedError("comb chains / unroll are not ported yet (ROADMAP B2)")
    fs = curve.field
    bx, by = (int(v) for v in (base if base is not None else (curve.gx, curve.gy)))
    tables, negbase, negbase_digits = device_tables(curve, bx, by, scalars.device)
    if scalars.device.type == "cpu":
        ax, ay, z = comb_plain(scalars, tables, curve, negbase, strict)
    else:
        limbs = kernel_tables(curve, bx, by, scalars.device)
        ax, ay, z = comb_planes(scalars.contiguous(), limbs, negbase_digits, curve, strict)
    return JacobianPoint(GFp(ax, fs), GFp(ay, fs), GFp(z, fs), curve)
