"""Kernels B's and the generic L's table read on the tensor cores
(``ecsimd_tpu_torch/csrc/comb_mma.cuh``), held on the CPU: the u8 layout of
``comb.mma_layout`` against ``comb.limb_layout``, and a numpy model of the
warp's selection — the staging's swizzle, the ldmatrix addresses, the
m16n8k32 u8 fragments as the PTX ISA assigns them to threads, the one-hot
built as the kernel builds it and the row buffer's packing — against the
entries each lane asked for. numpy and the port only; the kernel itself
runs on the card (``tests/test_torch_cuda.py``)."""

import numpy as np
import pytest

from ecsimd_tpu_torch.kernels import comb
from ecsimd_tpu_torch.specs import P256, P384, P521, SECP256K1, WEI25519

CURVES = {"p256": P256, "secp256k1": SECP256K1, "w25519": WEI25519, "p384": P384, "p521": P521}


def _tables(curve):
    return comb.base_tables(curve, curve.gx, curve.gy)[0]


def _entry_words(curve, j):
    """(K, 2 n) uint32: the entries of position j as ``limb_layout`` keeps
    them, the padding words dropped."""
    rows = comb.limb_layout(_tables(curve)).view(np.uint32)
    d = curve.field.ndigits
    n, w = (d + 1) // 2, comb.coord_words(d)
    first = 0 if j == 0 else comb.NENT + (j - 1) * comb.NENT // 2
    k = comb.NENT if j == 0 else comb.NENT // 2
    return np.concatenate([rows[first:first + k, :n], rows[first:first + k, w:w + n]], axis=1)


def mma_position(layout, j, entry_bytes):
    """Position j of ``comb.mma_layout``'s ``layout`` as its (entry_bytes, K)
    matrix."""
    first = 0 if j == 0 else comb.NENT + (j - 1) * comb.NENT // 2
    k = comb.NENT if j == 0 else comb.NENT // 2
    return layout[first * entry_bytes:(first + k) * entry_bytes].reshape(entry_bytes, k)


def _words(byte_rows):
    """(..., 4 m) bytes -> (..., m) little-endian 32-bit words."""
    b = np.asarray(byte_rows, np.int64).reshape(*np.shape(byte_rows)[:-1], -1, 4)
    return (b << np.array([0, 8, 16, 24])).sum(-1).astype(np.uint32)


@pytest.mark.parametrize("name", list(CURVES))
def test_one_hot_times_the_layout_is_the_entry(name):
    """On every curve, one-hot(e) x position j's matrix (int64) is
    ``limb_layout``'s row of entry e, for every e of positions 0, 1 and the
    last; the layout holds nothing else."""
    curve = CURVES[name]
    d = curve.field.ndigits
    layout = comb.mma_layout(_tables(curve))
    eb = comb.mma_entry_bytes(d)
    npos = curve.field.nbits // 8
    assert layout.dtype == np.uint8 and eb == 8 * ((d + 1) // 2)
    assert layout.shape == ((comb.NENT + (npos - 1) * comb.NENT // 2) * eb,)
    for j in (0, 1, npos - 1):
        m = mma_position(layout, j, eb).astype(np.int64)
        k = m.shape[1]
        assert m.shape == (eb, comb.NENT if j == 0 else comb.NENT // 2)
        got = np.eye(k, dtype=np.int64) @ m.T  # row e: one-hot(e) x the matrix
        assert got.min() >= 0 and got.max() <= 255
        np.testing.assert_array_equal(_words(got), _entry_words(curve, j))


# --- a model of comb_mma::select, one warp ------------------------------------------

LANES = np.arange(32)
G, T = LANES >> 2, LANES & 3


def stage(matrix):
    """The bytes the staging (``comb_mma::stage_copy``) writes: 16-byte
    chunk q of the position, row q >> log2(K / 16), goes to chunk q ^ (row
    & 7)."""
    rows, k = matrix.shape
    src = np.ascontiguousarray(matrix).reshape(-1, 16)
    q = np.arange(len(src))
    dst = np.empty_like(src)
    dst[q ^ ((q // (k // 16)) & 7)] = src
    return dst.reshape(-1)


def ldmatrix_x4(smem, addr):
    """ldmatrix.m8n8.x4.b16: lane 8 m + r gives the address of row r of
    matrix m; thread (g, t) gets, in register m, bytes 4 t .. 4 t + 3 of
    row g of matrix m. Returns (32, 4) uint32."""
    a = addr[8 * np.arange(4)[None, :] + G[:, None]] + 4 * T[:, None]  # (32, 4)
    return _words(smem[a[..., None] + np.arange(4)])


# the PTX ISA's m16n8k32 u8 fragments: element i of A (register i // 4,
# byte i % 4), of B, and accumulator register i of D, as (row, column)
_I16, _I8 = np.arange(16), np.arange(8)
_A_ROW = G[:, None] + 8 * ((_I16[None, :] >= 4) & (_I16[None, :] < 8) | (_I16[None, :] >= 12))
_A_COL = 4 * T[:, None] + (_I16 & 3)[None, :] + 16 * (_I16[None, :] >= 8)
_B_ROW = 4 * T[:, None] + (_I8 & 3)[None, :] + 16 * (_I8[None, :] >= 4)
_B_COL = np.broadcast_to(G[:, None], (32, 8))
_D_ROW = G[:, None] + 8 * (np.arange(4)[None, :] >= 2)
_D_COL = 2 * T[:, None] + (np.arange(4) & 1)[None, :]


def _elements(regs, n):
    """(32, n // 4) uint32 registers -> (32, n) u8 elements, low byte first."""
    r = np.asarray(regs, np.int64)
    return ((r[:, :, None] >> np.array([0, 8, 16, 24])) & 255).reshape(32, n)


def mma_m16n8k32(d, a, b):
    """d + a b as mma.sync.m16n8k32.row.col.s32.u8.u8.s32 computes it, each
    operand a (32, regs) array of the warp's fragment registers."""
    am = np.zeros((16, 32), np.int64)
    am[_A_ROW, _A_COL] = _elements(a, 16)
    bm = np.zeros((32, 8), np.int64)
    bm[_B_ROW, _B_COL] = _elements(b, 8)
    return d + (am @ bm)[_D_ROW, _D_COL]


def select(staged, idx, k, n):
    """What ``comb_mma::select<n, k / 32>`` leaves in each lane: (32, 2 n)
    words, x then y, from the staged position and each lane's index."""
    ksteps = k // 32
    a = np.zeros((32, 2, ksteps, 4), np.int64)
    for r in range(4):
        e = idx[G + 8 * r]  # __shfl_sync from lane g + 8 r
        v = (((e >> 2) & 3) == T).astype(np.int64) << ((e & 3) * 8)
        key = e >> 4
        for ks in range(ksteps):
            for h in range(2):
                a[:, r >> 1, ks, (r & 1) + 2 * h] = v & -(key == 2 * ks + h).astype(np.int64)
    base = (LANES & 7) * k
    chunk = [base + 16 * ((4 * p + (LANES >> 3)) ^ (LANES & 7)) for p in range(ksteps // 2)]
    rows = np.zeros((2, 32 * 4), np.int64)  # two slots of 32 rows of four 16-bit halves
    out = np.zeros((32, 2 * n), np.uint32)
    for nt in range(n):
        d = np.zeros((2, 32, 4), np.int64)
        for p in range(ksteps // 2):
            b = ldmatrix_x4(staged, chunk[p] + nt * 8 * k)
            for mt in range(2):
                d[mt] = mma_m16n8k32(d[mt], a[:, mt, 2 * p], b[:, 0:2])
                d[mt] = mma_m16n8k32(d[mt], a[:, mt, 2 * p + 1], b[:, 2:4])
        assert d.min() >= 0 and d.max() <= 255  # one nonzero term a sum: a byte
        slot = rows[nt & 1]
        for mt in range(2):
            slot[(16 * mt + G) * 4 + T] = d[mt][:, 0] | (d[mt][:, 1] << 8)
            slot[(16 * mt + G + 8) * 4 + T] = d[mt][:, 2] | (d[mt][:, 3] << 8)
        halves = slot.reshape(32, 4)  # lane L reads its row: 8 bytes
        out[:, 2 * nt] = halves[:, 0] | (halves[:, 1] << 16)
        out[:, 2 * nt + 1] = halves[:, 2] | (halves[:, 3] << 16)
    return out


CASES = {
    "edges": lambda k, rng: np.resize([0, 127, 128, 255] if k == 256 else [0, 1, 126, 127], 32),
    "one_entry": lambda k, rng: np.full(32, rng.integers(k)),
    "all_different": lambda k, rng: rng.permutation(k)[:32],
}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("name", list(CURVES))
def test_warp_selection_model_returns_each_lanes_entry(name, case):
    """The model of the kernel's selection returns each lane's entry of
    positions 0 (256 entries: indices 0, 127, 128, 255 among them) and 1
    (128 magnitudes), word for word: with all 32 lanes on one entry, and
    with all lanes on different entries."""
    curve = CURVES[name]
    d = curve.field.ndigits
    n = (d + 1) // 2
    layout = comb.mma_layout(_tables(curve))
    rng = np.random.default_rng(0xC0FFEE + 17 * d + len(case))
    for j in (0, 1):
        m = mma_position(layout, j, comb.mma_entry_bytes(d))
        k = m.shape[1]
        idx = np.asarray(CASES[case](k, rng), np.int64)
        got = select(stage(m), idx, k, n)
        np.testing.assert_array_equal(got, _entry_words(curve, j)[idx])


def test_staging_swizzle_spreads_an_ldmatrix_over_the_banks():
    """Each 8-row matrix an ldmatrix reads (one 16-byte chunk of 8
    consecutive rows) lands on 8 different 16-byte bank groups, at K = 128
    and K = 256."""
    for k in (128, 256):
        m = np.arange(16 * k, dtype=np.int64).reshape(16, k)  # cell ids
        staged = stage(m.astype(np.uint8))
        pos = np.empty(16 * k, np.int64)
        src = m.reshape(-1, 16)
        q = np.arange(len(src))
        pos[src[q ^ ((q // (k // 16)) & 7)].reshape(-1)] = np.arange(16 * k)
        for nt in range(2):
            for c in range(k // 16):
                start = pos[m[8 * nt:8 * nt + 8, 16 * c]]  # each row's chunk c, as staged
                assert (start % 16 == 0).all()
                assert len(set((start // 16 % 8).tolist())) == 8
        assert len(staged) == 16 * k


def test_smem_sizes_follow_the_layout():
    """Kernel B's and the generic L's dynamic shared memory, from the
    layout's entry bytes: 26, 38 and 53 KiB for B; 74 KiB for the generic L
    at four positions a step on P-256, 62 and 87 KiB at two on P-384 and
    P-521."""
    assert comb.MMA_ROW_BYTES == 2048
    assert [comb.serial_smem_bytes(c) for c in (P256, P384, P521)] == [26624, 38912, 54272]
    assert comb.general_smem_bytes(P256, 4) == 75776
    assert comb.general_smem_bytes(P384, 2) == 63488
    assert comb.general_smem_bytes(P521, 2) == 89088
