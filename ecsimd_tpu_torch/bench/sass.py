"""The instruction mix of the built kernels, by pipe, from ``cuobjdump -sass``.

    python -m ecsimd_tpu_torch.bench.sass [--lib PATH] [KERNEL_SUBSTRING ...]

prints one JSON object: for each kernel whose (mangled) name contains one of
the given substrings (default: kernels E, on its five curves, F, B and
the generic L on their five curves, plain and strict, A, D, J and K on
their five curves, G and H), its
static count of SASS instructions by class, the loops (the address ranges
of backward branches) with the classes of the instructions each holds
outside its inner loops, and, where the loop nest has the shape the source
gives it (``TRIPS``), the dynamic count per lane: each loop's own
instructions times the number of times it runs. The device functions a
kernel calls (P-384's and P-521's ``fe_mul`` and ``fe_sqr``, not inlined)
sit in the kernel's listing after its own code, from each CALL's target to
the first RET: each is counted once by class (``callees``, largest
multiply count first: the multiply, then the squaring), kept out of the
kernel's own loops, and its instructions enter the dynamic count a lane
once for each call the lane makes. The generic L's loops run as its
launch's ints say: the count is at chains 2, unroll 1 (one position a
step), and code in a branch that a lane takes only at some positions (a
chain's fold; kernel J's pending sum, kept at the first clear bit of the
step) counts at every position: an upper bound. Kernel D's count is a
thread's (``per_thread``), which converts G lanes (``AFFINE_GROUPS``), and
``per_lane`` is that over G; on P-384 and P-521 the block's one inversion
(the code from its first loop to its last, ``ONE_THREAD``) counts a
1 / 128 share in each thread, as thread 0 of the block's 128 runs it.
Kernel M (the batch sum's tree, five curves) has no per-lane loop nest:
its ``per_lane`` is the mix of one trip of its hottest lane loop (one
output lane's complete add), its callees' bodies once a call
(``lane_loop``), and ``lane_loops`` that of each call site of the add in
address order: the grid's lane loop, then block 0's level loop where its
lanes are in shared memory (one loop serves both where they are in the
scratch).
Without ``--lib`` it
builds (or reuses) this checkout's library. Needs the CUDA toolkit's
``cuobjdump``.

Classes: ``imad`` the multiply-add pipe (IMAD, IMAD.WIDE, IMAD.HI, IMAD.X,
IMUL), ``imad_move`` the moves, adds and shifts that ptxas also issues
there (IMAD.MOV, IMAD.IADD, IMAD.SHL), ``alu`` the integer ALU (IADD3,
LOP3, SHF, SEL, ISETP, LEA, PRMT, MOV, ...), ``imma`` the tensor cores'
integer products (IMMA), ``shfl`` the warp shuffles, ``uniform`` the
uniform datapath (U*), ``lds`` / ``sts`` shared memory (``lds128`` the
16-byte loads among them, ``ldsm`` the ldmatrix loads), ``ldl`` / ``stl``
local memory (spills, and the
registers a call saves), ``ldg`` / ``stg`` device memory (``ldg128`` the
16-byte loads among them, ``ldg_nc`` the loads through the read-only
path, ``ldg128_nc`` the 16-byte ones among those),
``control`` branches, calls and barriers, ``other`` the rest.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
from fractions import Fraction
from pathlib import Path

# kernel E on P-384 and P-521: their field multiplies are calls
WIDE_KERNELS = tuple(f"window{st}_{tag}_kernel" for tag in ("p384", "p521")
                     for st in ("", "_strict"))
# kernels B and the generic L, the comb's table read on the tensor cores
COMB_TAGS = ("p256", "secp256k1", "w25519", "p384", "p521")
COMB_KERNELS = tuple(f"comb{kind}{st}_{tag}_kernel" for kind in ("", "_general")
                     for tag in COMB_TAGS for st in ("", "_strict"))
# kernels A and D; J and K, the comb's tree and pipe
LADDER_KERNELS = tuple(f"ladder_{tag}_kernel" for tag in COMB_TAGS)
AFFINE_KERNELS = tuple(f"affine_{tag}_kernel" for tag in COMB_TAGS)
TREE_PIPE_KERNELS = tuple(f"comb_{kind}_{tag}_kernel" for kind in ("tree", "pipe")
                          for tag in COMB_TAGS)
# kernel M, the batch sum's tree (batch_sum_lane.cuh's batch_sum_tree)
BATCH_SUM_KERNELS = tuple(f"batch_sum_{tag}_kernel" for tag in COMB_TAGS)
# kernels G (X25519's x-only ladder; not kernel A's ladder_w25519_kernel,
# whose name it holds) and H (x / z)
X25519_KERNELS = ("mladder_w25519_kernel", "xdivz_w25519_kernel")
DEFAULT_KERNELS = ("window_p256_kernel", "window_strict_p256_kernel", "glv_secp256k1_kernel",
                   "glv_strict_secp256k1_kernel", "window_secp256k1_kernel",
                   "window_strict_secp256k1_kernel", "window_w25519_kernel",
                   "window_strict_w25519_kernel") + WIDE_KERNELS + COMB_KERNELS + (
                   LADDER_KERNELS + AFFINE_KERNELS + TREE_PIPE_KERNELS + X25519_KERNELS
                   + BATCH_SUM_KERNELS)

# Loop nests as the sources write them, outermost first, loops in address
# order: (name, iterations each time the loop is entered, inner loops).
# window*.cu (E on the 256-bit curves): the table's 7 adds; the 8 words of
# k, 8 windows each, 4 doublings each. On P-384 and P-521 E's persistent
# grid walks its lanes in one more loop (once a lane): 12 or 17 words, 8
# windows each but 4 in P-521's top word (132 in all: 132 / 17 a word on
# average). glv.cu: the table's 7 adds; 9 digits, 4 windows each, 4
# doublings and 2 lookup-and-adds each; the 2 fix-ups.
_E = [("table", 7, []), ("word", 8, [("window", 8, [("dbl", 4, [])])])]
_F = [("table", 7, []), ("digit", 9, [("window", 4, [("dbl", 4, []), ("add", 2, [])])]),
      ("fixup", 2, [])]


def _wide_e(words, windows):
    return [("lane", 1, [("table", 7, []),
                         ("word", words, [("window", Fraction(windows, words),
                                           [("dbl", 4, [])])])])]


# The comb at npos positions and N words a coordinate (32, 48, 66; 8,
# 12, 17). Kernel B (comb_mma_lane.cuh): the copies of positions 0 and 1
# (16-byte chunks over 128 threads: N, ceil(N / 2) a thread, thread 0's
# count), then positions 1 .. npos - 1, each staging the next but the
# last. The generic L (comb_general_lane.cuh) at one position a step:
# steps 0 and 1 staged, then npos steps, each but the first two staging
# the next, each but the first reading one position (the first step's
# position 0 is read before the loop).
def _comb_b(npos, n):
    c1 = -(-n // 2)
    return [("stage0", n, []), ("stage1", c1, []),
            ("position", npos - 1, [("stage", Fraction((npos - 2) * c1, npos - 1), [])])]


def _comb_general(npos, n):
    c1 = -(-n // 2)
    return [("step0", 1, [("copy", n, [])]), ("step1", 1, [("copy", c1, [])]),
            ("step", npos, [("stage", Fraction(npos - 2, npos), [("copy", c1, [])]),
                            ("position", Fraction(npos - 1, npos), [])])]


# Kernel K (comb_pipe_lane.cuh): the copies of positions 0, 1 and 2 before
# the loop, then positions 1 .. npos - 1, each staging position j + 2 but
# the last two.
def _comb_pipe(npos, n):
    c1 = -(-n // 2)
    return [("stage0", n, []), ("stage1", c1, []), ("stage2", c1, []),
            ("position", npos - 1, [("stage", Fraction((npos - 3) * c1, npos - 1), [])])]


# Kernel J (comb_tree_lane.cuh, comb_tree_wide_lane.cuh): step 0's copies
# (position 0 and npos / 2) and step 1's before the loop, then steps 1 ..
# kSteps - 1 (kSteps = npos / 2), each staging the next step's two
# positions but the last, and folding pending sums: at 256 bits the level
# loop runs once a level while the step's bit is set and once more where it
# clears (29 trips over steps 1 .. 15; the pending sum's store is in it);
# on P-384 / P-521 the fold loop once a pending sum folded (kSteps - 1 in
# all).
def _comb_tree(npos, n):
    c1, steps = -(-n // 2), npos // 2
    inner = Fraction(29, 15) if npos == 32 else Fraction(1)
    copies = [(f"copy{h}", Fraction((steps - 2) * c1, steps - 1), []) for h in ("_lo", "_hi")]
    return [("stage0", n, []), ("stage0_hi", c1, []), ("stage1_lo", c1, []),
            ("stage1_hi", c1, []), ("step", steps - 1, copies + [("fold", inner, [])])]


# The masked scan the two replaced (the parent of the tensor-core read), so
# that a library built before it reads too (--lib): its copies of 16-byte
# vectors (2 padded N words an entry), and its scan of each position, 4
# entries an iteration at 256 bits, 2 on P-384 and P-521, in loops of
# their own inside the position loop (position 0's at j = 0 only).
def _scan_b(npos, n):
    ev = 2 * (-(-n // 4))
    per = 4 if n == 8 else 2
    return [("stage0", 2 * ev, []),
            ("position", npos, [("stage", Fraction((npos - 1) * ev, npos), []),
                                ("scan0", Fraction(256 // per, npos), []),
                                ("scan", Fraction((npos - 1) * (128 // per), npos), [])])]


def _scan_general(npos, n):
    ev = 2 * (-(-n // 4))
    per = 4 if n == 8 else 2
    return [("step0", 1, [("copy", 2 * ev, [])]),
            ("step", npos, [("stage", Fraction(npos - 1, npos), [("copy", ev, [])]),
                            ("position", 1, [("scan0", Fraction(256 // per, npos), []),
                                             ("scan", Fraction((npos - 1) * (128 // per), npos),
                                              [])])])]


# Kernels K and J before their tensor-core read (--lib of a library built
# before it), as _scan_b: K's copies of positions 0, 1 and 2 and its scans
# of positions 0 and 1 before the loop, then positions 1 .. npos - 1 (the
# copy of j + 2, the scan of j + 1); J's copies of step 0's positions, then
# every step's: the next step's two copies, the scans of its lower position
# (position 0's at step 0 only) and of its upper one, the pending sums'
# loop (30 trips over the 16 steps at 256 bits; a fold a step but the
# first on P-384 / P-521).
def _scan_pipe(npos, n):
    ev = 2 * (-(-n // 4))
    per = 4 if n == 8 else 2
    return [("stage0", 2 * ev, []), ("stage1", ev, []), ("scan0", 256 // per, []),
            ("stage2", ev, []), ("scan1", 128 // per, []),
            ("position", npos - 1, [("stage", Fraction((npos - 3) * ev, npos - 1), []),
                                    ("scan", 128 // per, [])])]


def _scan_tree(npos, n):
    ev = 2 * (-(-n // 4))
    per = 4 if n == 8 else 2
    steps = npos // 2
    fold = Fraction(30, 16) if npos == 32 else Fraction(steps - 1, steps)
    return [("stage0", 2 * ev, []), ("stage0_hi", ev, []),
            ("step", steps, [("copy_lo", Fraction((steps - 1) * ev, steps), []),
                             ("copy_hi", Fraction((steps - 1) * ev, steps), []),
                             ("scan0", Fraction(256 // per, steps), []),
                             ("scan_lo", Fraction((steps - 1) * (128 // per), steps), []),
                             ("scan_hi", 128 // per, []), ("fold", fold, [])])]


# Kernel D's block tree: thread 0 of the block's 128 alone runs the code from
# the warps' walk forward (the first loop) to their walk back (the last),
# the inversion chain between them: (first loop, last loop, threads).
AFFINE_THREADS = 128


# Kernel A (ladder_lane.cuh): the scalar's words, then each word's bits: 16 D
# - 2 ZDAU steps over kWords words (bits 2 .. 31 of word 0, 16 in P-521's
# top word), the bit loop's trips a word on average.
def _ladder(words, digits):
    return [("word", words, [("bit", Fraction(16 * digits - 2, words), [])])]


# Kernel D (affine.cu, affine_lane.cuh): a thread's G lanes, and whether
# the block of 4 warps shares one inversion, a curve as affine.cu chooses
# them; its loops are its field's inversion chain's rolled squarings
# (field_<curve>.cuh's fe_inv, fe_sqr_n), in address order, P-521's doubling
# loop holding one of them (k = 8 .. 256: 504 squarings in 6 trips). On the
# 256-bit curves (a thread's own inversion) the walk back over the G lanes
# follows as a loop that ptxas unrolls four lanes a trip ((G - 1) // 4
# trips, the other lanes after it); with the block tree, one thread's
# forward and backward walks over the 4 warps' products (3 trips each)
# come before and after, and the count gives every thread that thread's
# walks and inversion (3 of the block's 4 warps skip them: an upper bound).
AFFINE_GROUPS = {"p256": (16, False), "secp256k1": (16, False), "w25519": (16, False),
                 "p384": (16, True), "p521": (8, True)}
_INV_SQUARINGS = {
    "p256": (3, 6, 3, 15, 2, 32, 128, 32, 30, 2),
    "secp256k1": (3, 3, 2, 11, 22, 44, 88, 44, 3, 23, 5, 3, 2),
    "w25519": (2, 5, 10, 20, 10, 50, 100, 50, 5),
    "p384": (3, 6, 3, 15, 2, 30, 60, 120, 15, 33, 94, 2),
    "p521": (2, 3, 4, (6, 504), 7, 2),
}


def _affine(tag):
    group, tree = AFFINE_GROUPS[tag]
    chain = [("sqr", n, []) if isinstance(n, int)
             else ("k", n[0], [("sqr", Fraction(n[1], n[0]), [])])
             for n in _INV_SQUARINGS[tag]]
    if tree:
        return [("warps", 3, [])] + chain + [("warps_back", 3, [])]
    return chain + [("back", (group - 1) // 4, [])]


# Kernel D before its batch inversion (a library built before it, --lib):
# each lane's square-and-multiply over the 8 words of p - 2 on P-256 and
# secp256k1, 32 bits a word, one rolled loop a word. The multiply sits in a
# branch on the exponent's bit, so the count takes it at every bit of a
# loop that holds it: an upper bound (P-256: 160 counted, 128 run;
# secp256k1: 256 counted, 249 run).
TRIPS_FERMAT = {f"affine_{tag}_kernel": [("word", 32, [])] * 8 for tag in ("p256", "secp256k1")}
ONE_THREAD = {f"affine_{tag}_kernel": (0, -1, AFFINE_THREADS)
              for tag, (_, tree) in AFFINE_GROUPS.items() if tree}

# Kernel G (mladder.cu): the scalar's 16 digit words, then each word's
# bits: 255 steps, 15 in the top word (before the lazy ladder: one loop of
# 255 steps, ``TRIPS_G_BITS``). Kernel H: its inversion chain's rolled
# squarings (field_w25519.cuh's fe_inv, as kernel D's on Wei25519).
_G = [("word", 16, [("bit", Fraction(255, 16), [])])]
TRIPS_G_BITS = {"mladder_w25519_kernel": [("bit", 255, [])]}

_COMB_SIZES = {"p256": (32, 8), "secp256k1": (32, 8), "w25519": (32, 8), "p384": (48, 12),
               "p521": (66, 17)}
TRIPS = {"glv_secp256k1_kernel": _F, "glv_strict_secp256k1_kernel": _F} | {
    f"window{st}_{tag}_kernel": _E for st in ("", "_strict")
    for tag in ("p256", "secp256k1", "w25519")} | {
    f"window{st}_{tag}_kernel": _wide_e(words, 4 * digits) for st in ("", "_strict")
    for tag, words, digits in (("p384", 12, 24), ("p521", 17, 33))} | {
    f"comb{kind}{st}_{tag}_kernel": fn(*size) for kind, fn in (("", _comb_b),
                                                                ("_general", _comb_general))
    for tag, size in _COMB_SIZES.items() for st in ("", "_strict")} | {
    f"ladder_{tag}_kernel": _ladder(n, 2 * n - (tag == "p521"))
    for tag, (_, n) in _COMB_SIZES.items()} | {
    f"affine_{tag}_kernel": _affine(tag) for tag in _COMB_SIZES} | {
    f"comb_{kind}_{tag}_kernel": fn(*size) for kind, fn in (("tree", _comb_tree),
                                                            ("pipe", _comb_pipe))
    for tag, size in _COMB_SIZES.items()} | {
    "mladder_w25519_kernel": _G,
    "xdivz_w25519_kernel": [("sqr", n, []) for n in _INV_SQUARINGS["w25519"]]}
TRIPS_SCAN = {f"comb{kind}{st}_{tag}_kernel": fn(*size)
              for kind, fn in (("", _scan_b), ("_general", _scan_general))
              for tag, size in _COMB_SIZES.items() for st in ("", "_strict")} | {
    f"comb_{kind}_{tag}_kernel": fn(*size) for kind, fn in (("tree", _scan_tree),
                                                            ("pipe", _scan_pipe))
    for tag, size in _COMB_SIZES.items()}

_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)\s*([^;]*);")
_FUNC = re.compile(r"Function\s*:\s*(\S+)")
_ALU = ("IADD3", "LOP3", "LOP", "SHF", "SHL", "SHR", "SEL", "ISETP", "LEA", "PRMT", "MOV",
        "PLOP3", "P2R", "R2P", "IABS", "IMNMX", "FLO", "POPC", "BMSK", "SGXT", "ISCADD", "IADD",
        "VIADD", "VIMNMX", "BREV", "CS2R", "S2R")
_CONTROL = ("BRA", "EXIT", "BAR", "BSSY", "BSYNC", "WARPSYNC", "RET", "CALL", "NOP", "YIELD",
            "BPT", "JMP", "BRX", "DEPBAR", "MEMBAR", "ERRBAR", "CCTL")


def classify(op: str) -> str:
    """The class of one SASS opcode (with its modifiers, e.g. IMAD.WIDE.U32)."""
    base = op.split(".")[0]
    if base in ("IMAD", "IMUL"):
        return "imad_move" if op.startswith(("IMAD.MOV", "IMAD.IADD", "IMAD.SHL")) else "imad"
    if base == "LDS":
        return "lds128" if ".128" in op else "lds"
    if base == "LDSM":
        return "ldsm"
    if base == "IMMA":
        return "imma"
    if base == "SHFL":
        return "shfl"
    if base in ("STS", "LDL", "STL", "LDG", "STG"):
        return base.lower()
    if base in _CONTROL:
        return "control"
    if base in _ALU:
        return "alu"
    if base.startswith("U") or base in ("LDC", "S2UR", "R2UR"):
        return "uniform"
    return "other"


def parse(text: str) -> dict[str, list[tuple[int, str, str]]]:
    """cuobjdump -sass output -> {function: [(address, opcode, operands)]}."""
    out, cur = {}, None
    for line in text.splitlines():
        m = _FUNC.search(line)
        if m:
            cur = out.setdefault(m.group(1), [])
            continue
        m = _LINE.search(line)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(2), m.group(3).strip()))
    return out


def _mix(instrs) -> dict[str, int]:
    counts: dict[str, int] = {}
    for _, op, _ in instrs:
        c = classify(op)
        counts[c] = counts.get(c, 0) + 1
        if c in ("lds128", "ldsm"):
            counts["lds"] = counts.get("lds", 0) + 1
        if c == "ldg":
            wide, nc = ".128" in op, ".CONSTANT" in op
            for key, on in (("ldg128", wide), ("ldg_nc", nc), ("ldg128_nc", wide and nc)):
                if on:
                    counts[key] = counts.get(key, 0) + 1
    counts["total"] = len(instrs)
    return counts


def callees(instrs) -> dict[int, list]:
    """{CALL target address: the instructions from it to the first RET}: the
    device functions a kernel calls, which ptxas lays out in the kernel's
    listing after its own code."""
    targets = sorted({int(m.group(1), 16) for _, op, args in instrs
                      if op.split(".")[0] == "CALL" and (m := re.search(r"0x([0-9a-f]+)", args))})
    out = {}
    for tgt in targets:
        body = []
        for x in instrs:
            if x[0] >= tgt:
                body.append(x)
                if x[1].split(".")[0] == "RET":
                    break
        out[tgt] = body
    return out


def own(instrs) -> list:
    """The kernel's own instructions: all but its callees' bodies."""
    inside = {x[0] for body in callees(instrs).values() for x in body}
    return [x for x in instrs if x[0] not in inside]


def loops(instrs) -> list[dict]:
    """The loops of one function: for each backward branch target, the range
    [target, last branch back to it], nested by containment, each with the
    mix of its own instructions (outside its inner loops). The one-line
    loop ptxas puts after the last EXIT is not a loop of the source."""
    ranges: dict[int, int] = {}
    for addr, op, args in instrs:
        if op.split(".")[0] == "BRA":
            m = re.search(r"0x([0-9a-f]+)", args)
            if m and int(m.group(1), 16) < addr:  # not the branch to itself after EXIT
                tgt = int(m.group(1), 16)
                ranges[tgt] = max(ranges.get(tgt, addr), addr)
    spans = sorted(ranges.items(), key=lambda r: (r[0], -r[1]))

    def build(items):
        nodes, i = [], 0
        while i < len(items):
            start, end = items[i]
            inner = [r for r in items[i + 1:] if r[0] >= start and r[1] <= end]
            nodes.append({"start": start, "end": end, "inner": build(inner)})
            i += 1 + len(inner)
        return nodes

    def own(node):
        skip = [(c["start"], c["end"]) for c in node["inner"]]
        body = [x for x in instrs if node["start"] <= x[0] <= node["end"]
                and not any(s <= x[0] <= e for s, e in skip)]
        node["mix"] = _mix(body)
        for c in node["inner"]:
            own(c)

    tree = build(spans)
    for n in tree:
        own(n)
    return tree


def dynamic(instrs, tree, trips, one_thread=None) -> dict[str, int] | None:
    """Instructions a lane issues, by class: the code outside every loop
    once, each loop's own instructions times its runs, each callee's body
    times the calls that reach it (``tree``: the loops of ``own(instrs)``).
    ``one_thread`` (first, last, threads): the code from the start of
    top-level loop ``first`` to the end of ``last`` runs in one thread of
    ``threads``, so it counts that share (rounded in the sum). None when
    the loop nest differs from ``trips``."""
    shape = lambda nodes: [shape(n["inner"]) for n in nodes]  # noqa: E731
    spec_shape = lambda spec: [spec_shape(t[2]) for t in spec]  # noqa: E731
    if shape(tree) != spec_shape(trips):
        return None
    body = own(instrs)
    runs = {x[0]: Fraction(1) for x in body}

    def walk(nodes, spec, outer):
        for node, (_, n, inner) in zip(nodes, spec):
            k = outer * n
            for x in body:
                if node["start"] <= x[0] <= node["end"]:
                    runs[x[0]] = k
            walk(node["inner"], inner, k)

    walk(tree, trips, Fraction(1))
    if one_thread is not None:
        first, last, threads = one_thread
        lo, hi = tree[first]["start"], tree[last]["end"]
        for x in body:
            if lo <= x[0] <= hi:
                runs[x[0]] /= threads
    total: dict[str, Fraction] = {}

    def add(instr, times):
        for k, v in _mix([instr]).items():
            total[k] = total.get(k, 0) + v * times

    for x in body:
        add(x, runs[x[0]])
    for tgt, fn in callees(instrs).items():
        calls = sum(runs[x[0]] for x in body if x[1].split(".")[0] == "CALL"
                    and re.search(rf"0x0*{tgt:x}\b", x[2]))
        for x in fn:
            add(x, calls)
    assert one_thread is not None or all(
        v.denominator == 1 for v in total.values() if isinstance(v, Fraction)), total
    return {k: round(v) for k, v in total.items()}


def lane_loops(instrs) -> list[dict]:
    """Kernel M's lane loops, by their mix a trip, in address order: of
    every loop of ``own(instrs)`` (at any depth), its own instructions with
    its callees' bodies counted once a CALL, those that hold at least half
    the most multiplies any one holds: each a call site of the complete add
    (the grid's lane loop, and block 0's level loop where its lanes are in
    shared memory; one loop where one call site serves both)."""
    body_of = callees(instrs)
    in_callee = {y[0] for fn in body_of.values() for y in fn}
    nodes = []

    def collect(tree):
        for node in tree:
            nodes.append(node)
            collect(node["inner"])

    collect(loops(own(instrs)))

    def trip(node):
        skip = [(c["start"], c["end"]) for c in node["inner"]]
        body = [x for x in instrs if node["start"] <= x[0] <= node["end"]
                and not any(s <= x[0] <= e for s, e in skip) and x[0] not in in_callee]
        total = dict(_mix(body))
        for tgt, fn in body_of.items():
            calls = sum(1 for x in body if x[1].split(".")[0] == "CALL"
                        and re.search(rf"0x0*{tgt:x}\b", x[2]))
            for k, v in _mix(fn).items():
                total[k] = total.get(k, 0) + v * calls
        return total

    trips = [(n["start"], trip(n)) for n in nodes]
    most = max((t.get("imad", 0) for _, t in trips), default=0)
    return [t for _, t in sorted(trips, key=lambda st: st[0])
            if most and 2 * t.get("imad", 0) >= most]


def lane_loop(instrs) -> dict | None:
    """Kernel M's hottest lane loop: of ``lane_loops(instrs)``, the one whose
    trip holds the most multiplies; None without a loop."""
    return max(lane_loops(instrs), key=lambda t: t.get("imad", 0), default=None)


def ptxas(log: str) -> dict[str, dict[str, int]]:
    """{mangled kernel name: {"registers", "smem_bytes", "stack_frame_bytes",
    "spill_stores", "spill_loads"}} from nvcc's -Xptxas -v output. A stack
    frame line belongs to the function its "Function properties for" line
    names: the properties of a device function a kernel calls (P-384's and
    P-521's ``fe_mul`` and ``fe_sqr``), which ptxas prints among the
    kernel's own lines, are the callee's and go under its own name (with
    no registers), not the kernel's."""
    out, cur, props = {}, None, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = props = m.group(1)
            out.setdefault(cur, {})
            continue
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            props = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and props is not None:
            entry = out.setdefault(props, {})
            entry["stack_frame_bytes"], entry["spill_stores"], entry["spill_loads"] = map(
                int, m.groups())
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            smem = re.search(r"(\d+) bytes smem", line)
            out[cur]["registers"] = int(m.group(1))
            out[cur]["smem_bytes"] = int(smem.group(1)) if smem else 0
    return out


def resources(report: dict, part: str) -> dict | None:
    """The ptxas entry of the kernel whose mangled name contains ``part``
    after a non-identifier character (the mangling's length digits: so
    ``ladder_w25519_kernel`` does not match ``mladder_w25519_kernel``), the
    shortest such name, or None."""
    pat = re.compile(r"(?<![A-Za-z_])" + re.escape(part))
    hits = sorted((k for k in report if pat.search(k)), key=len)
    return report[hits[0]] if hits else None


def cuobjdump() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is not None and (Path(CUDA_HOME) / "bin" / "cuobjdump").exists():
        return str(Path(CUDA_HOME) / "bin" / "cuobjdump")
    found = shutil.which("cuobjdump")
    if found is None:
        raise RuntimeError("cuobjdump not found: it comes with the CUDA toolkit")
    return found


def report(lib: Path, names=DEFAULT_KERNELS) -> dict:
    """The mix of each kernel of ``lib`` whose name contains one of ``names``
    after a non-identifier character (the shortest such name): static, by
    loop, and per lane."""
    text = subprocess.run([cuobjdump(), "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    funcs = parse(text)
    out = {}
    for name in names:
        # after a non-identifier character, as ``resources`` matches:
        # ``ladder_w25519_kernel`` is not ``mladder_w25519_kernel``
        pat = re.compile(r"(?<![A-Za-z_])" + re.escape(name))
        match = sorted((f for f in funcs if pat.search(f)), key=len)
        if not match:
            out[name] = None
            continue
        instrs = funcs[match[0]]
        tree = loops(own(instrs))
        called = sorted(callees(instrs).items(), key=lambda kv: -_mix(kv[1]).get("imad", 0))
        per_lane = current = None
        if name in BATCH_SUM_KERNELS:
            out[name] = {"function": match[0], "static": _mix(own(instrs)), "loops": tree,
                         "callees": [{"address": tgt, "static": _mix(fn)} for tgt, fn in called],
                         "per_lane": lane_loop(instrs), "lane_loops": lane_loops(instrs)}
            continue
        for trips in (TRIPS.get(name), TRIPS_SCAN.get(name), TRIPS_FERMAT.get(name),
                      TRIPS_G_BITS.get(name)):
            if per_lane is None and trips is not None:
                current = trips is TRIPS.get(name)
                per_lane = dynamic(instrs, tree, trips, ONE_THREAD.get(name) if current else None)
        out[name] = {"function": match[0], "static": _mix(own(instrs)), "loops": tree,
                     "callees": [{"address": tgt, "static": _mix(fn)} for tgt, fn in called],
                     "per_lane": per_lane}
        group = AFFINE_GROUPS.get(name.removeprefix("affine_").removesuffix("_kernel"))
        if name.startswith("affine_") and group and per_lane and current:
            out[name]["per_thread"] = per_lane
            out[name]["per_lane"] = {k: round(v / group[0]) for k, v in per_lane.items()}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--lib", type=Path, help="a built kernel library (default: this checkout's)")
    ap.add_argument("kernels", nargs="*", default=list(DEFAULT_KERNELS))
    args = ap.parse_args(argv)
    lib = args.lib
    if lib is None:
        from ecsimd_tpu_torch.kernels import _build

        lib = _build.library().path
    print(json.dumps(report(lib, args.kernels)))


if __name__ == "__main__":
    main()
