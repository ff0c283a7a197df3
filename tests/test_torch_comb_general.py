"""The comb's schedules on every curve of the port, checked without a card.

* Kernel J's walk on P-384 and P-521 (``comb.tree_schedule``), evaluated on
  expression trees (no field arithmetic), equals the stride tree of the
  JAX package's ``_tree_core``, run on those expressions; at 32 positions
  it is the 256-bit kernel J's bit-reversal walk; the checked-in schedule
  header is the generator's text.
* The generic kernel L's walk (chains of contiguous positions folded into a
  running total as it goes, positions staged ``general_group`` a step),
  written here in plain PyTorch, equals ``comb_chains_plain``; the
  schedules with chains * unroll = 8 match the oracle's composition.
* ``comb.schedule_planes`` (the card route of ``comb.scalar_mult_base``),
  with the launch stubbed, reaches for every schedule ``check_schedule``
  accepts, on each of the five curves, the kernel and the ints the route
  says: J, K, B, the templated L, or the generic L with (chains, unroll).

Tolerance: exact (0) — Jacobian planes bit for bit."""

import numpy as np
import pytest
import torch

from ecsimd_tpu.kernels import comb as jcomb
from ecsimd_tpu.kernels.digits import VGFp
from ecsimd_tpu.oracle import coz as ocoz
from ecsimd_tpu_torch.curves import group
from ecsimd_tpu_torch.curves.point import JacobianPoint
from ecsimd_tpu_torch.field import GFp
from ecsimd_tpu_torch.kernels import _build
from ecsimd_tpu_torch.kernels import comb as tcomb
from ecsimd_tpu_torch.specs import P256, P384, P521, SECP256K1, WEI25519
from tests.toy import TOY64, TOY64E
from tests.torch_helpers import (affine_ints, ints, oracle_comb_chains, port_spec, rand_ints,
                                 tplanes)

CPU = torch.device("cpu")


class _Root(Exception):
    """Raised by the stubbed fix-up with the tree's root expression."""


def _jax_tree(npos, monkeypatch):
    """The root of ``_tree_core``'s stride tree over ``npos`` positions, as
    an expression: leaves ("aff", i, i + npos/2), inner nodes ("jac", a, b)
    with a the first operand. The JAX package's adds are replaced by
    functions that make these expressions (one digit, a numpy object array
    a level), so nothing is traced or compiled."""

    def level(op, a, b):
        node = np.empty(len(a), dtype=object)
        node[:] = [(op, u, v) for u, v in zip(a, b)]
        return (VGFp([node], TOY64.field),) * 3

    def aff(x1, y1, x2, y2, curve):
        return level("aff", x1.digs[0], x2.digs[0])

    def jac(x1, y1, z1, x2, y2, z2, curve):
        return level("jac", x1.digs[0], x2.digs[0])

    def fix(x1, *_):
        raise _Root(x1.digs[0])

    monkeypatch.setattr(jcomb, "aff_add_any", aff)
    monkeypatch.setattr(jcomb, "add_any", jac)
    monkeypatch.setattr(jcomb, "add_z2_1_any", fix)
    monkeypatch.setattr(jcomb.jnp, "concatenate", np.concatenate)
    monkeypatch.setattr(VGFp, "const_like", lambda self, value: self)
    leaves = np.empty(npos, dtype=object)
    leaves[:] = list(range(npos))
    with pytest.raises(_Root) as root:
        jcomb._tree_core([leaves], [leaves], 0, TOY64, (0, 0))
    return root.value.args[0]


def _walk(schedule, npos):
    """The root of ``schedule`` run as kernel J runs it, on expressions."""
    pending, node = [], None
    for k, (pair, folds) in enumerate(schedule):
        node = ("aff", pair, pair + npos // 2)
        for _ in range(folds):
            node = ("jac", pending.pop(), node)
        if k + 1 < len(schedule):
            pending.append(node)
    assert not pending
    return node


@pytest.mark.parametrize("npos", [8, 32, 48, 66])
def test_tree_schedule_is_the_jax_stride_tree(npos, monkeypatch):
    """tree_schedule(npos) walked with a stack of pending sums builds the
    stride tree of the JAX package's _tree_core: the same pairs at every
    level, each add's operands in the same order, odd nodes passed on
    (P-384: 24 -> 12 -> 6 -> 3 -> 2 -> 1 nodes; P-521: 33 -> 17 -> 9 -> 5 ->
    3 -> 2 -> 1). Pending sums at most 4 on P-384, 5 on P-521."""
    schedule = tcomb.tree_schedule(npos)
    assert sorted(p for p, _ in schedule) == list(range(npos // 2))
    assert _walk(schedule, npos) == _jax_tree(npos, monkeypatch)
    assert tcomb.tree_pending(schedule) == {8: 2, 32: 4, 48: 4, 66: 5}[npos]


def test_tree_schedule_at_32_is_the_256_bit_walk():
    """At 32 positions the schedule is the 256-bit kernel J's loop: step k
    visits pair brev4(k) and folds as many pending sums as k has trailing
    ones (comb_tree_lane.cuh). P-384 walks pairs 0, 12, 6, 18, 3, ...;
    P-521 the 32 pairs of a 32-pair tree, then pair 32 (the odd node of
    every level), folded once at the root."""
    brev4 = [int(f"{k:04b}"[::-1], 2) for k in range(16)]
    ones = [len(f"{k:b}") - len(f"{k:b}".rstrip("1")) for k in range(16)]
    assert tcomb.tree_schedule(32) == list(zip(brev4, ones))
    assert [p for p, _ in tcomb.tree_schedule(48)[:5]] == [0, 12, 6, 18, 3]
    p521 = tcomb.tree_schedule(66)
    assert [p for p, _ in p521[:32]] == [int(f"{k:05b}"[::-1], 2) for k in range(32)]
    assert p521[32] == (32, 1)


def test_tree_schedule_header_is_generated():
    """The checked-in header is tree_schedule_header()'s text, and its tables
    cover P-384's and P-521's position counts."""
    text = (_build.CSRC / "comb_tree_schedule.cuh").read_text()
    assert text == tcomb.tree_schedule_header()
    assert tcomb.TREE_SCHEDULE_HEADER.endswith("csrc/comb_tree_schedule.cuh")
    npos = {c.field.nbits // tcomb.W for c in _build.WIDE_CURVES}
    assert npos == set(tcomb.TREE_SCHEDULE_NPOS)


# --- the generic kernel L -----------------------------------------------------------


def _general_walk(s, tables, curve, negbase, chains, unroll, strict):
    """The generic kernel L's walk (comb_general_lane.cuh) in plain PyTorch:
    positions in order, general_group of them a step; a chain of npos /
    chains positions reseeds from its first entry with z = 1 after folding
    the chain before it into the running total (jac_add(total, chain));
    every other position is an ADD_Z2_1 (strict: the complete add); the
    last chain is folded at the end, then the parity fix-up."""
    fs = curve.field
    npos = fs.nbits // tcomb.W
    per, g = npos // chains, tcomb.general_group(curve, unroll)
    entry = tcomb._entry_fn(s, tables, curve)

    def add(x, y, z, ex, ey):
        if not strict:
            return group.add_z2_1(x, y, z, ex, ey)
        p = group.jac_add_complete(
            JacobianPoint(x, y, z, curve), JacobianPoint(ex, ey, ex.const_like(1), curve))
        return p.x, p.y, p.z

    total, left = None, 0
    for step in range(npos // g):
        for q in range(g):
            j = step * g + q
            ex, ey = entry(j)
            if left == 0:
                if j == per:
                    total = (x, y, z)
                elif j > per:
                    total = group.jac_add(*total, x, y, z)
                x, y, z, left = ex, ey, GFp.one(fs, ex.planes), per
            else:
                x, y, z = add(x, y, z, ex, ey)
            left -= 1
    if per < npos:
        x, y, z = group.jac_add(*total, x, y, z)
    return tcomb._fixup(s, x, y, z, negbase, add)


def _toy_scalars(curve, seed, n):
    rng = np.random.default_rng(seed)
    return [1, 2, 5, curve.order - 2] + [k + 1 for k in rand_ints(rng, curve.order - 2, n - 4)]


@pytest.mark.parametrize("chains, unroll, strict", [
    (2, 1, False), (2, 2, False), (4, 1, False), (4, 2, False), (8, 1, False), (1, 2, False),
    (1, 8, False), (1, 8, True)], ids=lambda v: str(v))
def test_general_walk_is_comb_chains_plain(chains, unroll, strict):
    """The running-total walk equals comb_chains_plain on TOY64 (8
    positions; strict on TOY64E with k = n - 1 on lane 4): exact Jacobian
    planes."""
    curve = TOY64E if strict else TOY64
    tc = port_spec(curve)
    ks = _toy_scalars(curve, 180 + chains + unroll, 12)
    if strict:
        ks[4] = curve.order - 1
    s = tplanes(ks, curve.field.ndigits)
    tables, negbase, _ = tcomb.device_tables(tc, curve.gx, curve.gy, CPU)
    got = _general_walk(s, tables, tc, negbase, chains, unroll, strict)
    want = tcomb.comb_chains_plain(s, tables, tc, negbase, chains, unroll, strict)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("chains, unroll", [(8, 1), (4, 2), (2, 4), (1, 8)], ids=str)
def test_chains_times_unroll_8_vs_oracle(chains, unroll):
    """scalar_mult_base on CPU tensors at chains * unroll = 8 on TOY64
    (comb_chains_plain) against the composition of the same chains from the
    JAX package's oracle (exact Jacobian triples) and against its scalar
    multiplication (affine)."""
    ks = _toy_scalars(TOY64, 190 + chains, 8)
    tc = port_spec(TOY64)
    out = tcomb.scalar_mult_base(tplanes(ks, TOY64.field.ndigits), tc, chains=chains,
                                 unroll=unroll)
    tables, negbase = tcomb.base_tables(tc, TOY64.gx, TOY64.gy)
    got = list(zip(*(ints(t) for t in (out.x.planes, out.y.planes, out.z.planes))))
    assert got == [oracle_comb_chains(k, tables, negbase, TOY64, chains) for k in ks]
    assert affine_ints(got, TOY64.p) == [
        ocoz.scalar_mult_affine(k, TOY64.gx, TOY64.gy, TOY64) for k in ks]


def test_general_group_and_smem():
    """The positions the generic kernel L stages a step, and its shared
    memory (``comb.mma_layout``'s positions and the row buffers): unroll
    capped at 4 on the 256-bit curves (74 KiB) and 2 on P-384 / P-521 (62 /
    87 KiB)."""
    assert [tcomb.general_group(P256, u) for u in (1, 2, 4, 8, 32)] == [1, 2, 4, 4, 4]
    assert [tcomb.general_group(P384, u) for u in (1, 2, 3, 48)] == [1, 2, 2, 2]
    assert [tcomb.general_group(P521, u) for u in (1, 2, 3, 11, 66)] == [1, 2, 2, 2, 2]
    assert tcomb.general_smem_bytes(P256, 32) == 74 * 1024
    assert tcomb.general_smem_bytes(P384, 48) == 62 * 1024
    assert tcomb.general_smem_bytes(P521, 2) == 87 * 1024
    assert tcomb.general_smem_bytes(P521, 1) == 53 * 1024


# --- the card route of every schedule ------------------------------------------------


def _accepted(curve):
    """Every (chain, chains, unroll, strict) check_schedule accepts."""
    npos = curve.field.nbits // tcomb.W
    divisors = [m for m in range(1, npos + 1) if npos % m == 0]
    out = []
    for chain in tcomb.CHAINS:
        for c in divisors:
            for u in divisors:
                for st in (False, True):
                    try:
                        tcomb.check_schedule(curve, chain, c, u, st)
                    except ValueError:
                        continue
                    out.append((chain, c, u, st))
    return out


@pytest.mark.parametrize("curve", [P256, SECP256K1, WEI25519, P384, P521],
                         ids=lambda c: c.name)
def test_every_schedule_reaches_its_kernel(monkeypatch, curve):
    """comb.schedule_planes with the device check and the launch stubbed:
    the tree reaches J, the pipe K, one chain at unroll 1 kernel B (strict:
    B strict), a schedule of SCHEDULES_L on a 256-bit curve its templated
    L, every other the curve's generic L with (chains, unroll) as its ints
    — once each, on the curve's planes and its own table (the templated L
    ``kernel_tables``' int32 limbs; B, J, K and the generic L
    ``mma_tables``' bytes); nothing raises."""
    monkeypatch.setattr(_build, "require_cuda", lambda t, what: None)
    calls = []
    monkeypatch.setattr(_build, "launch", lambda kernel, tensors, batch, *ints:
                        calls.append((kernel.symbol, ints, tuple(tensors[0].shape),
                                      tensors[1].dtype)))
    tag = _build.CURVE_TAGS[curve][0]
    d = curve.field.ndigits
    npos = curve.field.nbits // tcomb.W
    s = torch.zeros((d, 4), dtype=torch.int32)
    kept = tcomb.NENT + (npos - 1) * tcomb.NENT // 2
    limbs = torch.zeros((kept, 2 * tcomb.coord_words(d)), dtype=torch.int32)
    mma = torch.zeros(kept * tcomb.mma_entry_bytes(d), dtype=torch.uint8)
    nb = torch.zeros(2 * d, dtype=torch.int32)
    schedules = _accepted(curve)
    assert len(schedules) > 3 * len([m for m in range(1, npos + 1) if npos % m == 0])
    general = set()
    for chain, c, u, st in schedules:
        calls.clear()
        tcomb.schedule_planes(s, limbs, mma, nb, curve, chain, c, u, st)
        sfx = "_strict" if st else ""
        if chain != "serial":
            want = (f"ec_comb_{chain}_{tag}", ())
        elif c == u == 1:
            want = (f"ec_comb_{tag}{sfx}", ())
        elif (curve, c, u, st) in tcomb.KERNELS_CHAINS:
            want = (f"ec_comb_chains_{tag}_c{c}u{u}{sfx}", ())
        else:
            want = (f"ec_comb_general_{tag}{sfx}", (c, u))
            general.add((c, u, st))
        table = torch.int32 if want[0].startswith("ec_comb_chains") else torch.uint8
        assert calls == [(*want, (d, 4), table)], (chain, c, u, st)
    # the generic kernel takes every schedule of the serial chain the
    # templated instantiations do not: on P-384 / P-521 all of them but B's
    n_serial = len([v for v in schedules if v[0] == "serial" and v[1:3] != (1, 1)])
    n_templated = len([k for k in tcomb.KERNELS_CHAINS if k[0] == curve])
    assert len(general) == n_serial - n_templated
    assert tcomb.KERNELS_GENERAL[(curve, False)].launches >= len(general) // 2
