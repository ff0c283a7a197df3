"""Kernel E's table split on P-384 and P-521 (``csrc/window_table.cuh``,
``Split``; ``kernels/window.table_split``) on the CPU, with no compiler: a
word-level model of the put and the masked scan — P-521's packed top words
among them — run on residues below p, the split's arithmetic against the
card's shared memory, the sources' constants against the Python split, the
persistent grid's walk over the lanes, and the wrapper's scratch check.
No JAX call: the file takes a few seconds.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from ecsimd_tpu_torch.kernels import _build, window
from ecsimd_tpu_torch.specs import P384, P521

CSRC = Path(__file__).resolve().parent.parent / "ecsimd_tpu_torch" / "csrc"
WIDE = [P384, P521]
SMEM_PER_BLOCK = 232_448  # the most a block can take (227 KiB)
SMEM_PER_SM = 233_472  # the SM's shared memory (228 KiB), 1 KiB of it reserved a block
M32 = 0xFFFFFFFF


def words(v: int, n: int) -> list[int]:
    return [(v >> (32 * k)) & M32 for k in range(n)]


def value(ws) -> int:
    return sum(int(w) << (32 * k) for k, w in enumerate(ws))


class Model:
    """The Split table of one block at N words, K entries on chip, as the C
    writes and reads it: shared rows of ``threads`` 16-byte columns,
    scratch rows of ``slots`` columns."""

    def __init__(self, curve, slots):
        sp = window.table_split(curve)
        self.n = (curve.field.ndigits + 1) // 2  # 32-bit words: 12, 17
        self.sp, self.slots = sp, slots
        self.smem = np.zeros((sp.on_chip * sp.vecs + sp.top_vecs, sp.threads, 4), np.uint32)
        self.scratch = np.zeros((sp.scratch_vecs, slots, 4), np.uint32)

    def put(self, t, x, y, z, j, slot):
        sp, c = self.sp, self.n // 4
        for k, a in enumerate((x, y, z)):
            for q in range(c):
                quad = a[4 * q:4 * q + 4]
                if t < sp.on_chip:
                    self.smem[t * sp.vecs + k * c + q, j] = quad
                else:
                    self.scratch[(t - sp.on_chip) * sp.vecs + k * c + q, slot] = quad
        if sp.top_vecs:
            top = x[-1] | y[-1] << 9 | z[-1] << 18
            self.smem[sp.on_chip * sp.vecs + (t >> 2), j, t & 3] = top

    def get(self, idx, j, slot):
        sp, c, n = self.sp, self.n // 4, self.n
        out = [[0] * n for _ in range(3)]
        for t in range(window.TABLE):  # every entry is read
            mask = M32 if idx == t else 0
            for k in range(3):
                for q in range(c):
                    v = (self.smem[t * sp.vecs + k * c + q, j] if t < sp.on_chip else
                         self.scratch[(t - sp.on_chip) * sp.vecs + k * c + q, slot])
                    for r in range(4):
                        out[k][4 * q + r] |= int(v[r]) & mask
        if sp.top_vecs:
            top = 0
            for h in range(window.TABLE // 4):
                v = self.smem[sp.on_chip * sp.vecs + h, j]
                for r in range(4):
                    top |= int(v[r]) & (M32 if idx == 4 * h + r else 0)
            out[0][n - 1], out[1][n - 1], out[2][n - 1] = top & 0x1FF, top >> 9 & 0x1FF, top >> 18
        return out


def _residues(curve, case):
    p = curve.p
    if case == "edges":
        vals = [0, 1, p - 1, 1 << (p.bit_length() - 9 if curve == P521 else 383)]
        vals += [p - 2, (p - 1) >> 1]
    else:
        rng = np.random.default_rng(0x7AB1E)
        vals = [int.from_bytes(rng.bytes(72), "little") % p for _ in range(24)]
    return vals


@pytest.mark.parametrize("case", ["edges", "random"])
@pytest.mark.parametrize("curve", WIDE, ids=lambda c: c.name)
def test_split_table_round_trip(curve, case):
    """Eight entries (x, y, z) of canonical residues — on P-521 the edges 0,
    1, p - 1 and 2^512 among them — put into two threads' columns of the
    split table and read back by the masked scan at every index: each
    entry comes back word for word, and the other thread's column is
    untouched by the first's."""
    vals = _residues(curve, case)
    n = (curve.field.ndigits + 1) // 2
    model = Model(curve, slots=3 * window.table_split(curve).threads)
    entries = {}
    for j, slot in ((5, 69), (6, 70)):
        ent = [[words(vals[(3 * t + k + j) % len(vals)], n) for k in range(3)]
               for t in range(window.TABLE)]
        for t, (x, y, z) in enumerate(ent):
            model.put(t, x, y, z, j, slot)
        entries[(j, slot)] = ent
    for (j, slot), ent in entries.items():
        for idx in range(window.TABLE):
            assert model.get(idx, j, slot) == ent[idx], (j, idx)
    assert all(value(w) < curve.p for ent in entries.values() for e in ent for w in e)


@pytest.mark.parametrize("v", ["zero", "one", "p-1", "2^512", "random"])
def test_p521_top_word_packing(v):
    """An entry's three P-521 top words (bits 512 .. 520) pack into one
    32-bit word, x | y << 9 | z << 18, and unpack to themselves; a residue
    below p has a top word below 2^9."""
    p = P521.p
    edge = {"zero": 0, "one": 1, "p-1": p - 1, "2^512": 1 << 512}.get(v)
    if edge is None:
        rng = np.random.default_rng(521)
        triples = [tuple(int.from_bytes(rng.bytes(72), "little") % p for _ in range(3))
                   for _ in range(64)]
    else:
        triples = [(edge, 0, p - 1), (p - 1, edge, 1), (1, p - 1, edge), (edge, edge, edge)]
    for x, y, z in triples:
        tops = [words(a, 17)[16] for a in (x, y, z)]
        assert all(t < 1 << 9 for t in tops)
        packed = tops[0] | tops[1] << 9 | tops[2] << 18
        assert packed < 1 << 27
        assert [packed & 0x1FF, packed >> 9 & 0x1FF, packed >> 18] == tops


@pytest.mark.parametrize("curve", WIDE, ids=lambda c: c.name)
def test_split_arithmetic(curve):
    """The split's numbers: the on-chip and scratch vectors cover the eight
    entries' whole words exactly once (and P-521's top words in two
    vectors); a block's shared memory fits the card's per-block limit and
    the target four blocks an SM fit its 228 KiB with 1 KiB reserved each;
    64 threads a block, eight warps an SM."""
    sp = window.table_split(curve)
    n = (curve.field.ndigits + 1) // 2
    assert sp.vecs == 3 * (n // 4)
    assert sp.on_chip * sp.vecs + sp.scratch_vecs == window.TABLE * sp.vecs
    assert 4 * sp.vecs == 3 * (n - n % 4)  # an entry's whole words
    assert 4 * sp.top_vecs == (window.TABLE if n % 4 else 0)  # one packed top word an entry
    assert sp.threads == 64 and sp.blocks * sp.threads // 32 == 8
    assert sp.smem_bytes <= SMEM_PER_BLOCK
    assert sp.blocks * (sp.smem_bytes + 1024) <= SMEM_PER_SM
    assert sp.scratch_bytes == sp.scratch_vecs * 16
    assert (sp.on_chip, sp.smem_bytes, sp.scratch_bytes) == {
        P384: (6, 55_296, 288), P521: (4, 51_200, 768)}[curve]


@pytest.mark.parametrize("curve", WIDE, ids=lambda c: c.name)
def test_sources_hold_the_python_split(curve):
    """The source's split constant is the Python split's ``on_chip``, its
    kernels run 64 threads four blocks an SM, and it exports the
    occupancy and shared-memory queries of both modes."""
    tag = _build.CURVE_TAGS[curve][0]
    src = (CSRC / f"window_{tag}.cu").read_text()
    m = re.search(rf"constexpr int kOnChip{tag.upper()} = (\d+);", src)
    assert m and int(m.group(1)) == window.table_split(curve).on_chip
    head = (CSRC / "window_table.cuh").read_text()
    assert "constexpr int kThreads = 64;" in head
    assert "__launch_bounds__(kThreads, 4)" in (CSRC / "window.cuh").read_text()
    for st in ("", "_strict"):
        for q in ("smem", "occupancy"):
            assert f'extern "C" int ec_window_{tag}{st}_{q}(void)' in src


@pytest.mark.parametrize("batch", [1, 63, 64, 65, 4_096, 70_000])
@pytest.mark.parametrize("slots", [64, 1_024, 33_792])
def test_persistent_walk_covers_every_lane_once(batch, slots):
    """The launcher's grid (min(slots, B rounded up to blocks) / 64 blocks of
    64 threads) and the kernel's walk (thread slot takes lanes slot, slot +
    slots, ...) visit every lane of the batch exactly once, and no thread
    touches a scratch column beyond ``slots``."""
    t = 64
    blocks = min(slots // t, (batch + t - 1) // t)
    seen = np.zeros(batch, np.int64)
    for slot in range(blocks * t):
        assert slot < slots
        seen[slot:batch:slots] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("bad", ["rows", "slots", "last", "dtype", "layout"])
@pytest.mark.parametrize("curve", WIDE, ids=lambda c: c.name)
def test_scratch_check_refuses_a_wrong_scratch(curve, bad):
    """check_scratch takes the (scratch_vecs, slots, 4) int32 layout, slots a
    multiple of 64, and raises on anything else."""
    v = window.table_split(curve).scratch_vecs
    cpu = torch.device("cpu")
    assert window.check_scratch(torch.empty((v, 128, 4), dtype=torch.int32), curve, cpu) == 128
    t = {"rows": torch.empty((v + 1, 128, 4), dtype=torch.int32),
         "slots": torch.empty((v, 100, 4), dtype=torch.int32),
         "last": torch.empty((v, 128, 2), dtype=torch.int32),
         "dtype": torch.empty((v, 128, 4), dtype=torch.int64),
         "layout": torch.empty((4, 128, v), dtype=torch.int32).permute(2, 1, 0)}[bad]
    with pytest.raises(ValueError, match="scratch"):
        window.check_scratch(t, curve, cpu)
