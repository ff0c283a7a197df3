"""Fixed-base comb k_i * B: the CUDA kernels of every schedule of the JAX
package's ``comb_mont_planes`` — B (serial, ``csrc/comb.cu`` on P-256,
secp256k1 and Wei25519, ``csrc/comb_p384.cu`` and ``comb_p521.cu``), J
(pairwise tree, ``csrc/comb_tree.cu``), K (pipelined serial chain,
``csrc/comb_pipe.cu``) and L (``chains`` independent chains / ``unroll``
positions a step, ``csrc/comb_chains.cuh``), J, K and L on the 256-bit
curves only (ROADMAP B0c) — their wrappers, their plain PyTorch versions
and the host-built tables.

Replaces ``ecsimd_tpu/kernels/comb.py`` (``comb_mont_planes`` and its
Pallas bodies ``_comb_kernel``, ``_comb_kernel_tree`` and
``_comb_kernel_pipe``). The tables are
built once on the host with Python ints for the shared base: entry e of
position i >= 1 holds the affine (2e - 255) * 2^(8i) * B, and position 0
additionally folds in the recoding's constant top digit, so the scalar
multiplication is 31 mixed additions and no doublings (``strict``: 31
complete adds, ``group.jac_add_complete``, each with one doubling computed
beside it). ``_batch_inv``,
``_to_internal`` and ``base_tables`` are copies of the JAX package's
pure-Python ones (a test asserts equal output); ``entry_indices`` and
``comb_plain`` are PyTorch ports of ``entry_indices`` and
``comb_xla_planes``, and ``comb_plain`` is the plain version of kernels B
and K and of L with one chain; ``comb_tree_plain`` ports ``_tree_core`` /
``comb_tree_host_planes`` (kernel J's plain version) and
``comb_chains_plain`` follows ``_comb_kernel``'s multi-chain semantics
(kernel L's).

Scalar domain: k in [1, order-1), minus the measure-zero degenerate class
of scalars whose prefix sums collide with a table entry's x line
(``ecsimd_tpu/kernels/comb.py`` docstring); the tree adds subset sums and
multi-chain adds cross-chain sums, a wider class of the same measure;
``strict`` (serial, one chain): all of [1, order), k = order - 1 included
(its chain ends at infinity and the fix-up resolves inf + (-B) = -B).

No kernel reads a table word at an address that depends on the scalar, as
the TPU kernel's one-hot read of the whole position does not: the block
stages each position in shared memory and every lane scans all of it with
masks. Their table layout (``kernel_tables``) keeps a position's entries as
32-bit limbs, and only the positive half of positions 1..31 (the sign is a
masked negation). The plain versions keep the indexed gather: they are the
comparators, and run on the main path only for CPU tensors.
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
KERNEL_W25519_STRICT = _build.Kernel(
    symbol="ec_comb_w25519_strict",
    source="ecsimd_tpu_torch/csrc/comb.cu",
    replaces="ecsimd_tpu/kernels/comb.py:213 _comb_kernel (Wei25519, strict=True)",
    n_pointers=6,
)
# (curve, strict) -> kernel B instantiation
KERNELS = {
    (P256, False): KERNEL, (P256, True): KERNEL_STRICT,
    (SECP256K1, False): KERNEL_SECP256K1, (SECP256K1, True): KERNEL_SECP256K1_STRICT,
    (WEI25519, False): KERNEL_W25519, (WEI25519, True): KERNEL_W25519_STRICT,
}
for _curve in _build.WIDE_CURVES:
    _tag, _name = _build.CURVE_TAGS[_curve]
    for _st in (False, True):
        KERNELS[(_curve, _st)] = _build.Kernel(
            symbol=f"ec_comb_{_tag}{'_strict' if _st else ''}",
            source=f"ecsimd_tpu_torch/csrc/comb_{_tag}.cu",
            replaces=f"ecsimd_tpu/kernels/comb.py:213 _comb_kernel ({_name}"
                     f"{', strict=True' if _st else ''})",
            n_pointers=6,
        )
# kernel L's (chains, unroll, strict) instantiations on every curve; chains
# = unroll = 1 is kernel B
SCHEDULES_L = ((2, 1, False), (2, 2, False), (4, 1, False), (1, 2, False), (1, 4, False),
               (1, 2, True), (1, 4, True))


def _schedule_kernel(curve: CurveSpec, stem: str, source: str, replaces: str,
                     opts: str = "") -> _build.Kernel:
    """Kernel J, K or L on ``curve``. ``{tag}`` in ``stem``, its C name,
    becomes the curve's tag; in ``source`` it becomes ``_<tag>``, or
    nothing on P-256."""
    tag, name = _build.CURVE_TAGS[curve]
    opts = ", ".join(o for o in (name, opts) if o)
    return _build.Kernel(
        symbol=f"ec_{stem.format(tag=tag)}",
        source=f"ecsimd_tpu_torch/csrc/{source.format(tag='' if curve == P256 else '_' + tag)}",
        replaces=replaces + (f" ({opts})" if opts else ""),
        n_pointers=6,
    )


# curve -> kernel J / K instantiation
KERNELS_TREE = {c: _schedule_kernel(c, "comb_tree_{tag}", "comb_tree.cu",
                                    "ecsimd_tpu/kernels/comb.py:416 _comb_kernel_tree")
                for c in _build.CURVES_256}
KERNELS_PIPE = {c: _schedule_kernel(c, "comb_pipe_{tag}", "comb_pipe.cu",
                                    "ecsimd_tpu/kernels/comb.py:337 _comb_kernel_pipe")
                for c in _build.CURVES_256}
# (curve, chains, unroll, strict) -> kernel L instantiation
KERNELS_CHAINS = {
    (curve, c, u, st): _schedule_kernel(
        curve, f"comb_chains_{{tag}}_c{c}u{u}{'_strict' if st else ''}",
        f"{'comb_unroll' if c == 1 else 'comb_chains'}{{tag}}.cu",
        "ecsimd_tpu/kernels/comb.py:213 _comb_kernel",
        f"chains={c}, unroll={u}{', strict=True' if st else ''}; grid and permutation :624")
    for curve in _build.CURVES_256 for c, u, st in SCHEDULES_L
}
CHAINS = ("serial", "tree", "pipe")


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
    """Comb tables as (npos, 256, 2D) int32 digits on ``device`` (a copy).

    Takes each table a JAX comb takes, as a numpy array (or anything
    ``np.asarray`` reads): the int32 digits of this module's and the JAX
    package's ``base_tables(...)[0]``; the JAX package's f32 digit tables
    (``_device_tables``, what its tree and pipe read); and its int8
    half-digit tables (``_device_tables8``, (npos, 256, 4D), byte 2k the low
    byte of digit k and 2k+1 its high byte, each biased by -128)."""
    arr = np.asarray(np_tables)
    if arr.ndim != 3 or arr.shape[1] != NENT:
        raise ValueError(f"expected (npos, {NENT}, 2D) tables, got {arr.dtype} {arr.shape}")
    if arr.dtype == np.float32:
        digits = arr.astype(np.int32)
        if not np.array_equal(digits, arr) or digits.min() < 0 or digits.max() >= 1 << DIGIT_BITS:
            raise ValueError("f32 tables: expected integral 16-bit digits")
    elif arr.dtype == np.int8:
        if arr.shape[2] % 4:
            raise ValueError(f"int8 half-digit tables: expected (npos, {NENT}, 4D), got {arr.shape}")
        b = arr.astype(np.int32) + 128
        digits = b[..., 0::2] | (b[..., 1::2] << 8)
    elif arr.dtype == np.int32:
        digits = arr
    else:
        raise ValueError(f"expected int32, f32 or int8 (half-digit) tables, got {arr.dtype}")
    return torch.tensor(digits, dtype=torch.int32, device=device)


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


def coord_words(d: int) -> int:
    """32-bit words a coordinate of ``d`` digits takes in the kernels' table
    layout: its ceil(d / 2) limbs, padded with zero words to a whole number
    of 16-byte vectors (8 at 16 digits, 12 at 24, 20 at 33)."""
    return -(-((d + 1) // 2) // 4) * 4


def limb_layout(np_tables):
    """Kernel B's table layout from (npos, 256, 2D) int32 digit tables:
    (256 + (npos - 1) * 128, 2 W) int32 rows, one per kept entry, each the
    W = ``coord_words(D)`` words of x then of y: a coordinate's 32-bit limbs
    (digits 2k, 2k + 1; with D odd the last limb holds one digit), then
    zero words. Position 0 keeps its 256 entries; positions 1..npos-1 keep
    entries 128..255, the positive multiples (2m+1) 2^(8i) B in magnitude
    order (entry 127 - m is their opposite)."""
    t = np.asarray(np_tables).astype(np.int64)
    d = t.shape[2] // 2
    w = coord_words(d)
    coords = []
    for c in (t[..., :d], t[..., d:]):
        if d % 2:
            c = np.concatenate([c, np.zeros(c.shape[:-1] + (1,), np.int64)], axis=-1)
        limbs = (c[..., 0::2] & 0xFFFF) | (c[..., 1::2] << DIGIT_BITS)
        pad = np.zeros(limbs.shape[:-1] + (w - limbs.shape[-1],), np.int64)
        coords.append(np.concatenate([limbs, pad], axis=-1))
    limbs = np.concatenate(coords, axis=-1)
    rows = np.concatenate([limbs[0], limbs[1:, NENT // 2 :].reshape(-1, 2 * w)])
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


def _entry_fn(scalars, tables, curve: CurveSpec):
    """i -> the (x, y) GFp of each lane's table entry at position i."""
    fs = curve.field
    d = fs.ndigits
    idx = entry_indices(scalars, curve)

    def entry(i):
        e = tables[i][idx[i]].t()  # (2d, B)
        return GFp(e[:d], fs), GFp(e[d:], fs)

    return entry


def _fixup(scalars, x, y, z, negbase, add):
    """The parity fix-up: even k computed (k + 1) B, so add -B on even lanes.
    Returns Jacobian (ax, ay, z) int32 planes."""
    sx, sy, sz = add(x, y, z, x.const_like(negbase[0]), x.const_like(negbase[1]))
    meven = 1 - (scalars[0] & 1)
    return sx.select(meven, x).planes, sy.select(meven, y).planes, sz.select(meven, z).planes


def comb_plain(scalars, tables, curve: CurveSpec, negbase, strict: bool = False):
    """Plain PyTorch comb on (D, B) planes, in the order of the JAX
    package's ``comb_xla_planes``: seed from the position-0 entry with
    z = 1, one ADD_Z2_1 per position 1..npos-1, then add -B on even lanes.
    ``strict`` replaces every add with ``group.jac_add_complete`` against
    the entry with z = 1. Returns Jacobian (ax, ay, z) int32 planes. The
    plain version of kernels B and K, and of L with one chain (``unroll``
    changes no value)."""
    fs = curve.field
    entry = _entry_fn(scalars, tables, curve)

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
    return _fixup(scalars, x, y, z, negbase, add)


def comb_chains_plain(scalars, tables, curve: CurveSpec, negbase, chains: int,
                      unroll: int = 1, strict: bool = False):
    """Plain version of kernel L: ``chains`` independent serial chains, in
    the order of the JAX package's ``_comb_kernel`` with ``chains > 1``.
    Chain c sums positions c * (npos / chains) .. (c + 1) * (npos / chains)
    - 1 in order, seeded from its first entry with z = 1 (only chain 0's
    seed, position 0, carries the top digit), one ADD_Z2_1 per further
    position; the chains are combined left to right with ``group.jac_add``
    (acc_0 + acc_1, then + acc_2, ...), then the parity fix-up. ``unroll``
    (positions a chain takes per staging step) changes no value; with one
    chain this is ``comb_plain``, ``strict`` included. Returns Jacobian
    (ax, ay, z) int32 planes."""
    check_schedule(curve, "serial", chains, unroll, strict)
    if chains == 1:
        return comb_plain(scalars, tables, curve, negbase, strict)
    fs = curve.field
    entry = _entry_fn(scalars, tables, curve)
    per = _npos(fs.nbits) // chains
    accs = []
    for c in range(chains):
        x, y = entry(c * per)
        z = GFp.one(fs, x.planes)
        for i in range(c * per + 1, (c + 1) * per):
            x, y, z = group.add_z2_1(x, y, z, *entry(i))
        accs.append((x, y, z))
    x, y, z = accs[0]
    for acc in accs[1:]:
        x, y, z = group.jac_add(x, y, z, *acc)
    return _fixup(scalars, x, y, z, negbase, group.add_z2_1)


def comb_tree_plain(scalars, tables, curve: CurveSpec, negbase):
    """Plain version of kernel J: the JAX package's ``comb_tree_host_planes``
    / ``_tree_core``, batched over a point axis as there. Level 1 adds entry
    i to entry i + npos/2 (``group.aff_add``, affine + affine); each further
    level adds node i to node i + n/2 of the n nodes left (``group.jac_add``,
    the lower index first), an odd last node passing on unchanged; then the
    parity fix-up. Returns Jacobian (ax, ay, z) int32 planes."""
    fs = curve.field
    d = fs.ndigits
    npos = _npos(fs.nbits)
    assert npos % 2 == 0
    idx = entry_indices(scalars, curve)
    ent = tables[torch.arange(npos, device=idx.device)[:, None], idx]  # (npos, B, 2d)
    ent = ent.permute(2, 0, 1)  # (2d, npos, B): digit planes with a point axis

    def part(g, a, b):
        return GFp(g.planes[:, a:b], fs)

    ex, ey = GFp(ent[:d], fs), GFp(ent[d:], fs)
    half = npos // 2
    x, y, z = group.aff_add(part(ex, 0, half), part(ey, 0, half),
                            part(ex, half, npos), part(ey, half, npos))
    while x.planes.shape[1] > 1:
        n = x.planes.shape[1]
        h = n // 2
        nxt = group.jac_add(part(x, 0, h), part(y, 0, h), part(z, 0, h),
                            part(x, h, 2 * h), part(y, h, 2 * h), part(z, h, 2 * h))
        if n % 2:
            nxt = [GFp(torch.cat([a.planes, b.planes[:, 2 * h:]], dim=1), fs)
                   for a, b in zip(nxt, (x, y, z))]
        x, y, z = nxt
    x, y, z = (GFp(t.planes[:, 0], fs) for t in (x, y, z))
    return _fixup(scalars, x, y, z, negbase, group.add_z2_1)


def check_schedule(curve: CurveSpec, chain: str, chains: int, unroll: int, strict: bool):
    """Raise ``ValueError`` on a schedule the JAX package's
    ``comb_mont_planes`` rejects: ``chain`` not serial, tree or pipe;
    ``npos % (unroll * chains) != 0``; ``strict`` other than with the serial
    chain and one chain."""
    if chain not in CHAINS:
        raise ValueError(f"chain {chain!r}: expected one of {CHAINS}")
    if not (isinstance(chains, int) and isinstance(unroll, int) and chains >= 1 and unroll >= 1):
        raise ValueError(f"chains {chains!r}, unroll {unroll!r}: expected positive ints")
    npos = _npos(curve.field.nbits)
    if npos % (unroll * chains):
        raise ValueError(f"npos {npos} not a multiple of unroll*chains {unroll * chains}")
    if strict and (chain != "serial" or chains != 1):
        raise ValueError("strict comb: serial single-chain only (tree/pipe/multi-chain keep "
                         "the documented measure-zero degenerate class)")


def _launch(kernel, scalars, tables, negbase_digits, curve: CurveSpec):
    """Check the operands of a comb kernel (B, J, K or L) and launch it.
    Returns Jacobian (ax, ay, z) planes (internal domain)."""
    d = curve.field.ndigits
    shape = (d, scalars.shape[-1])
    dev = scalars.device
    npos = _npos(curve.field.nbits)
    _build.check_planes("scalars", scalars, shape, dev)
    _build.check_planes("tables", tables, (NENT + (npos - 1) * NENT // 2, 2 * coord_words(d)),
                        dev)
    _build.check_planes("negbase", negbase_digits, (2 * d,), dev)
    if tables.data_ptr() % 16:
        raise ValueError("tables: the comb kernels stage entries as 16-byte words; need "
                         "16-byte alignment")
    ax, ay, z = (torch.empty(shape, dtype=torch.int32, device=dev) for _ in range(3))
    _build.launch(kernel, [scalars, tables, negbase_digits, ax, ay, z], shape[1])
    kernel.launches += 1
    return ax, ay, z


def _require_256(curve: CurveSpec, what: str):
    """Kernels J, K and L run on the 256-bit curves only."""
    if curve not in _build.CURVES_256:
        raise NotImplementedError(
            f"{curve.name}: the CUDA {what} covers P-256, secp256k1 and Wei25519; on P-384 and "
            "P-521 the serial comb (kernel B) runs on the card, this schedule on CPU tensors "
            "only (ROADMAP B0c)")


def comb_planes(scalars, tables, negbase_digits, curve: CurveSpec = P256, strict: bool = False):
    """Run kernel B (``strict``: its complete-add instantiation) on (D, B)
    int32 CUDA scalar planes with ``kernel_tables`` and the negbase digits
    of ``device_tables``. Returns Jacobian (ax, ay, z) planes (internal
    domain)."""
    _build.require_cuda(scalars, "comb")
    kernel = KERNELS.get((curve, bool(strict)))
    if kernel is None:
        raise NotImplementedError(
            f"{curve.name}: the CUDA comb covers P-256, secp256k1, Wei25519, P-384 and P-521")
    return _launch(kernel, scalars, tables, negbase_digits, curve)


def comb_tree_planes(scalars, tables, negbase_digits, curve: CurveSpec = P256):
    """Run kernel J, the pairwise tree, on CUDA planes (operands as
    ``comb_planes``); bit-exact with ``comb_tree_plain``."""
    _build.require_cuda(scalars, "comb tree")
    _require_256(curve, "comb tree")
    return _launch(KERNELS_TREE[curve], scalars, tables, negbase_digits, curve)


def comb_pipe_planes(scalars, tables, negbase_digits, curve: CurveSpec = P256):
    """Run kernel K, the pipelined serial chain, on CUDA planes (operands
    as ``comb_planes``); bit-exact with kernel B and ``comb_plain``."""
    _build.require_cuda(scalars, "comb pipe")
    _require_256(curve, "comb pipe")
    return _launch(KERNELS_PIPE[curve], scalars, tables, negbase_digits, curve)


def comb_chains_planes(scalars, tables, negbase_digits, curve: CurveSpec = P256,
                       chains: int = 2, unroll: int = 1, strict: bool = False):
    """Run kernel L, ``chains`` independent chains taking ``unroll``
    positions each per staging step, on CUDA planes (operands as
    ``comb_planes``); bit-exact with ``comb_chains_plain`` (with one chain,
    with kernel B)."""
    _build.require_cuda(scalars, "comb chains")
    check_schedule(curve, "serial", chains, unroll, strict)
    _require_256(curve, "comb chains")
    kernel = KERNELS_CHAINS.get((curve, chains, unroll, bool(strict)))
    if kernel is None:
        raise NotImplementedError(
            f"chains={chains}, unroll={unroll}, strict={strict}: kernel L runs chains and unroll "
            "in {1, 2, 4} with chains * unroll in {2, 4} (strict with one chain; chains = unroll "
            "= 1 is kernel B); other schedules run on CPU tensors only (ROADMAP B9)")
    return _launch(kernel, scalars, tables, negbase_digits, curve)


def scalar_mult_base(
    scalars, curve: CurveSpec = P256, base: tuple[int, int] | None = None,
    strict: bool = False, chain: str = "serial", chains: int = 1, unroll: int = 1,
) -> JacobianPoint:
    """k_i * B for a base shared by every lane (default: the generator).

    scalars: (D, B) classical digit planes. ``strict`` uses complete
    additions (scalar domain [1, order); serial chain, one chain only).
    ``chain``, ``chains`` and ``unroll`` are the JAX package's schedules:
    ``chain="tree"`` sums the positions by a pairwise tree (kernel J),
    ``chain="pipe"`` pipelines the serial chain (kernel K; its value is the
    serial one), and the serial chain runs ``chains`` independent
    accumulators taking ``unroll`` positions a step (kernel L; one chain
    and unroll 1 is kernel B). The tree and the pipe ignore ``chains`` and
    ``unroll`` once they are valid, as the JAX package does. CUDA tensors
    go to the kernels, CPU tensors to the plain versions. Raises
    ``ValueError`` on a schedule the JAX package rejects."""
    check_schedule(curve, chain, chains, unroll, strict)
    fs = curve.field
    bx, by = (int(v) for v in (base if base is not None else (curve.gx, curve.gy)))
    tables, negbase, negbase_digits = device_tables(curve, bx, by, scalars.device)
    if scalars.device.type == "cpu":
        if chain == "tree":
            ax, ay, z = comb_tree_plain(scalars, tables, curve, negbase)
        elif chain == "serial":
            ax, ay, z = comb_chains_plain(scalars, tables, curve, negbase, chains, unroll, strict)
        else:
            ax, ay, z = comb_plain(scalars, tables, curve, negbase)
    else:
        limbs = kernel_tables(curve, bx, by, scalars.device)
        s = scalars.contiguous()
        if chain == "tree":
            ax, ay, z = comb_tree_planes(s, limbs, negbase_digits, curve)
        elif chain == "pipe":
            ax, ay, z = comb_pipe_planes(s, limbs, negbase_digits, curve)
        elif chains == unroll == 1:
            ax, ay, z = comb_planes(s, limbs, negbase_digits, curve, strict)
        else:
            ax, ay, z = comb_chains_planes(s, limbs, negbase_digits, curve, chains, unroll, strict)
    return JacobianPoint(GFp(ax, fs), GFp(ay, fs), GFp(z, fs), curve)
