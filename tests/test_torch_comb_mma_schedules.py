"""Kernels J's and K's table read on the tensor cores, held on the CPU: their
shared-memory layouts at the u8 layout (``csrc/comb_tree.cu``,
``comb_tree_wide.cuh``, ``comb_pipe_lane.cuh``, ``comb_mma.cuh``), J's two
selections a step through ``tests/test_torch_comb_mma.py``'s model of the
warp's selection, K's double buffering against its read-ahead, and the
wrappers' routing of ``mma_tables``. numpy and the port only; the kernels
themselves run on the card (``tests/test_torch_cuda.py``)."""

import numpy as np
import pytest
import torch

from ecsimd_tpu_torch.kernels import _build, comb
from ecsimd_tpu_torch.specs import P256, P384, P521, SECP256K1, WEI25519
from tests.test_torch_comb_mma import _tables, mma_position, select, stage

CURVES = {"p256": P256, "secp256k1": SECP256K1, "w25519": WEI25519, "p384": P384, "p521": P521}
SM_SMEM = 233472  # bytes of shared memory an H100 SM holds for blocks
BLOCK_SMEM = 232448  # the most a block may have (227 KiB)
RESERVED = 1024  # shared memory the runtime keeps for each block
# the blocks an SM that PERF.md states for J and K (their registers bind
# before their shared memory does)
STATED_BLOCKS = {"tree": {"p256": 4, "secp256k1": 3, "w25519": 4, "p384": 2, "p521": 2},
                 "pipe": {"p256": 3, "secp256k1": 3, "w25519": 4, "p384": 2, "p521": 2}}


def _npos(curve):
    return curve.field.nbits // comb.W


def _sizes(curve):
    """Bytes of position 0's matrix, of any other position's, of an entry."""
    eb = comb.mma_entry_bytes(curve.field.ndigits)
    return comb.NENT * eb, comb.NENT // 2 * eb, eb


def tree_slots(curve):
    """Kernel J's shared memory as the sources lay it out: name -> (offset,
    bytes): buffer 0's slot of position 0 or the step's lower position and
    its slot of the upper one, buffer 1's two, the four warps' row
    buffers."""
    big, small, _ = _sizes(curve)
    out = {(0, 0): (0, big), (0, 1): (big, small), (1, 0): (big + small, small),
           (1, 1): (big + 2 * small, small)}
    out["rows"] = (big + 3 * small, comb.MMA_ROW_BYTES)
    return out


def pipe_slots(curve):
    """Kernel K's (kernel B's) shared memory: the even positions' buffer
    (position 0's size), the odd positions', the row buffers."""
    big, small, _ = _sizes(curve)
    return {0: (0, big), 1: (big, small), "rows": (big + small, comb.MMA_ROW_BYTES)}


def _disjoint(slots):
    spans = sorted(slots.values())
    return all(a + n <= b for (a, n), (b, _) in zip(spans, spans[1:]))


def tree_steps(curve):
    """Kernel J's walk: the level-1 pair (lower position) of each step, in
    order (the 4-bit reversal at 32 positions, ``tree_schedule`` above)."""
    npos = _npos(curve)
    if npos == 32:
        return [int(f"{k:04b}"[::-1], 2) for k in range(16)]
    return [p for p, _ in comb.tree_schedule(npos)]


@pytest.mark.parametrize("name", list(CURVES))
def test_tree_and_pipe_shared_memory_layouts(name):
    """On every curve J's slots (position 0's, three of 128 entries) and the
    row buffers, and K's two buffers and the row buffers, do not overlap
    and end at ``tree_smem_bytes`` / ``pipe_smem_bytes`` (K's is kernel B's);
    each fits the 227 KiB a block may have, and the SM's shared memory holds
    at least the blocks an SM that PERF.md states. Every position J stages
    fits the slot its step puts it in: position 0 only at step 0, into
    buffer 0's large slot."""
    curve = CURVES[name]
    big, small, _ = _sizes(curve)
    for slots, size, kind in ((tree_slots(curve), comb.tree_smem_bytes(curve), "tree"),
                              (pipe_slots(curve), comb.pipe_smem_bytes(curve), "pipe")):
        assert _disjoint(slots)
        assert max(a + n for a, n in slots.values()) == size <= BLOCK_SMEM
        assert SM_SMEM // (size + RESERVED) >= STATED_BLOCKS[kind][name]
    assert comb.pipe_smem_bytes(curve) == comb.serial_smem_bytes(curve)
    slots = tree_slots(curve)
    half = _npos(curve) // 2
    for k, lo in enumerate(tree_steps(curve)):
        assert (lo == 0) == (k == 0)
        for hi, p in ((0, lo), (1, lo + half)):
            assert slots[(k & 1, hi)][1] >= (big if p == 0 else small)


def test_shared_memory_sizes():
    """J: 42, 62 and 87 KiB (the stack of pending sums in thread-local
    memory); K: kernel B's 26, 38 and 53 KiB."""
    assert [comb.tree_smem_bytes(c) for c in (P256, P384, P521)] == [43008, 63488, 89088]
    assert [comb.pipe_smem_bytes(c) for c in (P256, P384, P521)] == [26624, 38912, 54272]


def _plain_entries(curve, j, e):
    """Entry e of position j of the plain comb's table, (x, y) ints in the
    field's internal form."""
    t = _tables(curve)
    d = curve.field.ndigits
    return [(sum(int(v) << (16 * i) for i, v in enumerate(t[j, k, :d])),
             sum(int(v) << (16 * i) for i, v in enumerate(t[j, k, d:]))) for k in e]


def _ints(words, n):
    return [(sum(int(w) << (32 * i) for i, w in enumerate(r[:n])),
             sum(int(w) << (32 * i) for i, w in enumerate(r[n:]))) for r in words]


@pytest.mark.parametrize("name", list(CURVES))
def test_tree_two_selections_a_step(name):
    """J's two selections of a step through the model of the warp's
    selection, on shared memory laid out as J's:
    step 0 (position 0's 256 signed entries in buffer 0's large slot,
    indices 0, 127, 128 and 255 among them, and position npos / 2), the step
    that reads the top position npos - 1, and a step in buffer 1; each
    selection with 32 distinct indices in the warp, both signs. The two
    entries are the plain comb's table entries of the lanes' indices."""
    curve = CURVES[name]
    d = curve.field.ndigits
    n = (d + 1) // 2
    npos, half = _npos(curve), _npos(curve) // 2
    layout = comb.mma_layout(_tables(curve))
    eb = comb.mma_entry_bytes(d)
    slots = tree_slots(curve)
    steps = tree_steps(curve)
    top = steps.index(half - 1)
    rng = np.random.default_rng(0x7EE + d)
    for k in (0, top, 1):
        lo = steps[k]
        smem = np.zeros(comb.tree_smem_bytes(curve), np.uint8)
        for hi, p in ((0, lo), (1, lo + half)):
            off, _ = slots[(k & 1, hi)]
            staged = stage(mma_position(layout, p, eb))
            smem[off:off + len(staged)] = staged
        got = []
        for hi, p in ((0, lo), (1, lo + half)):
            edges = [0, 127, 128, 255] if p == 0 else []
            rest = np.setdiff1d(np.arange(comb.NENT), edges)
            e = np.concatenate([edges, rng.permutation(rest)[:32 - len(edges)]]).astype(np.int64)
            assert (e < 128).any() and (e >= 128).any() and len(set(e.tolist())) == 32
            off, size = slots[(k & 1, hi)]
            if p == 0:  # all 256 signed entries: the selection is the entry
                words = select(smem[off:off + size], e, comb.NENT, n)
                got.append((_ints(words, n), _plain_entries(curve, 0, e)))
            else:  # the magnitude's entry, y negated on the negative half
                m = np.where(e < 128, 127 - (e & 127), e & 127)
                words = select(smem[off:off + size], m, comb.NENT // 2, n)
                p_ = curve.field.p
                sel = [(x, (p_ - y) % p_ if ng else y)
                       for (x, y), ng in zip(_ints(words, n), e < 128)]
                got.append((sel, _plain_entries(curve, p, e)))
        for sel, want in got:
            assert sel == want
        if k == top:
            assert lo + half == npos - 1


def pipe_events(npos):
    """Kernel K's staging and reads as comb_pipe_lane.cuh orders them:
    ("stage", position, buffer), ("wait", groups left in flight),
    ("sync",), ("read", position, buffer)."""
    ev = [("stage", 0, 0), ("stage", 1, 1), ("wait", 1), ("sync",), ("read", 0, 0), ("sync",),
          ("stage", 2, 0), ("wait", 1), ("sync",), ("read", 1, 1), ("sync",)]
    for j in range(1, npos):
        if j + 1 < npos:
            if j + 2 < npos:
                ev += [("stage", j + 2, j & 1), ("wait", 1)]
            else:
                ev += [("wait", 0)]
            ev += [("sync",), ("read", j + 1, (j + 1) & 1)]
        ev += [("sync",)]
    return ev


@pytest.mark.parametrize("npos", [32, 48, 66])
def test_pipe_read_ahead_keeps_two_buffers_apart(npos):
    """K's schedule of copies, barriers and reads on two buffers: each
    position is read once, in order, from the buffer of its parity, after
    its copy group has landed and a barrier; no copy goes into a buffer
    whose position has not been read, nor before a barrier after that
    read. So the read-ahead needs no third buffer."""
    held, landed, pending, read = {}, set(), [], []
    last_read = {}  # buffer -> event index of its last read
    last_sync = -1
    for i, ev in enumerate(pipe_events(npos)):
        if ev[0] == "stage":
            _, p, b = ev
            if b in held:
                assert held[b] in read and last_read[b] < last_sync, (p, b)
            held[b] = p
            pending.append(p)
        elif ev[0] == "wait":
            while len(pending) > ev[1]:
                landed.add(pending.pop(0))
        elif ev[0] == "sync":
            last_sync = i
        else:
            _, p, b = ev
            assert held[b] == p and p in landed and p % 2 == b
            read.append(p)
            last_read[b] = i
    assert read == list(range(npos))


@pytest.mark.parametrize("chain", ["tree", "pipe"])
@pytest.mark.parametrize("name", list(CURVES))
def test_schedule_planes_hands_j_and_k_the_u8_table(monkeypatch, name, chain):
    """comb.schedule_planes with the device check and the launch stubbed
    hands J (tree) and K (pipe) the u8 table itself; their wrappers refuse
    a table of 32-bit limbs, naming mma_tables."""
    curve = CURVES[name]
    monkeypatch.setattr(_build, "require_cuda", lambda t, what: None)
    calls = []
    monkeypatch.setattr(_build, "launch", lambda kernel, tensors, batch, *ints:
                        calls.append((kernel, tensors)))
    d = curve.field.ndigits
    kept = comb.NENT + (_npos(curve) - 1) * comb.NENT // 2
    s = torch.zeros((d, 4), dtype=torch.int32)
    mma = torch.zeros(kept * comb.mma_entry_bytes(d), dtype=torch.uint8)
    limbs = torch.zeros((kept, 2 * comb.coord_words(d)), dtype=torch.int32)
    nb = torch.zeros(2 * d, dtype=torch.int32)
    comb.schedule_planes(s, mma, nb, curve, chain)
    (kernel, tensors), = calls
    want = (comb.KERNELS_TREE if chain == "tree" else comb.KERNELS_PIPE)[curve]
    assert kernel is want and tensors[1] is mma
    wrapper = comb.comb_tree_planes if chain == "tree" else comb.comb_pipe_planes
    with pytest.raises(ValueError, match="mma_tables"):
        wrapper(s, limbs, nb, curve)


@pytest.mark.parametrize("name", list(CURVES))
def test_schedules_l_route_to_kernel_l(monkeypatch, name):
    """Every schedule of comb.SCHEDULES_L that the curve accepts reaches
    kernel L (KERNELS_GENERAL, chains and unroll as its ints, on the u8
    table) through schedule_planes and scalar_mult_base; the ones it
    refuses (P-521's 66 positions) raise ValueError on both."""
    curve = CURVES[name]
    monkeypatch.setattr(_build, "require_cuda", lambda t, what: None)
    calls = []
    monkeypatch.setattr(_build, "launch", lambda kernel, tensors, batch, *ints:
                        calls.append((kernel, tensors[1].dtype, ints)))
    d = curve.field.ndigits
    kept = comb.NENT + (_npos(curve) - 1) * comb.NENT // 2
    s = torch.zeros((d, 4), dtype=torch.int32)
    mma = torch.zeros(kept * comb.mma_entry_bytes(d), dtype=torch.uint8)
    nb = torch.zeros(2 * d, dtype=torch.int32)
    routed = 0
    for c, u, st in comb.SCHEDULES_L:
        calls.clear()
        if _npos(curve) % (c * u):
            with pytest.raises(ValueError):
                comb.schedule_planes(s, mma, nb, curve, "serial", c, u, st)
            continue
        comb.schedule_planes(s, mma, nb, curve, "serial", c, u, st)
        assert calls == [(comb.KERNELS_GENERAL[(curve, st)], torch.uint8, (c, u))]
        routed += 1
    assert routed == (3 if curve == P521 else 7)


def test_nothing_builds_a_limb_table_for_a_kernel():
    """No comb kernel takes a table of 32-bit limbs any more: comb has no
    kernel_tables, KERNELS_CHAINS or uses_kernel_tables, no source scans a
    staged position with masks (comb_stage.cuh holds the constants, the
    entry index and the cp.async groups), and the build has 27 sources."""
    for gone in ("kernel_tables", "KERNELS_CHAINS", "uses_kernel_tables", "comb_chains_planes"):
        assert not hasattr(comb, gone), gone
    names = {p.name for p in _build.CSRC.iterdir()}
    assert not {n for n in names if n.startswith(("comb_chains", "comb_unroll", "comb_scan"))}
    stage = (_build.CSRC / "comb_stage.cuh").read_text()
    assert "scan(" not in stage and "uint4" not in stage
    assert len(_build.SOURCES) == 27
    assert not any("comb_chains" in n or "comb_unroll" in n for n in _build.SOURCES)
