"""The instruction mix of the built kernels, by pipe, from ``cuobjdump -sass``.

    python -m ecsimd_tpu_torch.bench.sass [--lib PATH] [KERNEL_SUBSTRING ...]

prints one JSON object: for each kernel whose (mangled) name contains one of
the given substrings (default: kernels E, on its three curves, and F,
plain and strict), its
static count of SASS instructions by class, the loops (the address ranges
of backward branches) with the classes of the instructions each holds
outside its inner loops, and, where the loop nest has the shape the source
gives it (``TRIPS``), the dynamic count per lane: each loop's own
instructions times the number of times it runs. Without ``--lib`` it
builds (or reuses) this checkout's library. Needs the CUDA toolkit's
``cuobjdump``.

Classes: ``imad`` the multiply-add pipe (IMAD, IMAD.WIDE, IMAD.HI, IMAD.X,
IMUL), ``imad_move`` the moves, adds and shifts that ptxas also issues
there (IMAD.MOV, IMAD.IADD, IMAD.SHL), ``alu`` the integer ALU (IADD3,
LOP3, SHF, SEL, ISETP, LEA, PRMT, MOV, ...), ``uniform`` the uniform
datapath (U*), ``lds`` / ``sts`` shared memory (``lds128`` the 16-byte
loads among them), ``ldl`` / ``stl`` local memory (spills), ``ldg`` /
``stg`` device memory, ``control`` branches and barriers, ``other`` the
rest.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
from pathlib import Path

DEFAULT_KERNELS = ("window_p256_kernel", "window_strict_p256_kernel", "glv_secp256k1_kernel",
                   "glv_strict_secp256k1_kernel", "window_secp256k1_kernel",
                   "window_strict_secp256k1_kernel", "window_w25519_kernel",
                   "window_strict_w25519_kernel")
# kernel E on P-384 and P-521 (pass them by name): their field multiplies
# are calls, whose instructions sit in the callee (fe_mul, fe_sqr), outside
# these counts; only the static counts are given, with the P-521 top word's
# four windows the nest has no single shape for TRIPS
WIDE_KERNELS = tuple(f"window{st}_{tag}_kernel" for tag in ("p384", "p521")
                     for st in ("", "_strict"))

# Loop nests as the sources write them, outermost first, loops in address
# order: (name, iterations each time the loop is entered, inner loops).
# window*.cu (E on every curve): the table's 7 adds; the 8 words of k, 8
# windows each, 4 doublings each. glv.cu: the table's 7 adds; 9 digits, 4 windows each, 4
# doublings and 2 lookup-and-adds each; the 2 fix-ups.
_E = [("table", 7, []), ("word", 8, [("window", 8, [("dbl", 4, [])])])]
_F = [("table", 7, []), ("digit", 9, [("window", 4, [("dbl", 4, []), ("add", 2, [])])]),
      ("fixup", 2, [])]
TRIPS = {"glv_secp256k1_kernel": _F, "glv_strict_secp256k1_kernel": _F} | {
    f"window{st}_{tag}_kernel": _E for st in ("", "_strict")
    for tag in ("p256", "secp256k1", "w25519")}

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
        if c == "lds128":
            counts["lds"] = counts.get("lds", 0) + 1
    counts["total"] = len(instrs)
    return counts


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


def _walk(nodes):
    for n in nodes:
        yield n
        yield from _walk(n["inner"])


def dynamic(instrs, tree, trips) -> dict[str, int] | None:
    """Instructions a lane issues, by class: the code outside every loop
    once, each loop's own instructions times its runs. None when the loop
    nest differs from ``trips``."""
    shape = lambda nodes: [shape(n["inner"]) for n in nodes]  # noqa: E731
    spec_shape = lambda spec: [spec_shape(t[2]) for t in spec]  # noqa: E731
    if shape(tree) != spec_shape(trips):
        return None
    inside = {x[0] for n in _walk(tree) for x in instrs if n["start"] <= x[0] <= n["end"]}
    total = _mix([x for x in instrs if x[0] not in inside])

    def add(nodes, spec, runs):
        for node, (_, n, inner) in zip(nodes, spec):
            for k, v in node["mix"].items():
                total[k] = total.get(k, 0) + v * runs * n
            add(node["inner"], inner, runs * n)

    add(tree, trips, 1)
    return total


def ptxas(log: str) -> dict[str, dict[str, int]]:
    """{mangled kernel name: {"registers", "smem_bytes", "stack_frame_bytes",
    "spill_stores", "spill_loads"}} from nvcc's -Xptxas -v output."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = out.setdefault(m.group(1), {})
        elif cur is not None:
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                          r"(\d+) bytes spill loads", line)
            if m:
                cur["stack_frame_bytes"], cur["spill_stores"], cur["spill_loads"] = map(
                    int, m.groups())
            m = re.search(r"Used (\d+) registers", line)
            if m:
                smem = re.search(r"(\d+) bytes smem", line)
                cur["registers"] = int(m.group(1))
                cur["smem_bytes"] = int(smem.group(1)) if smem else 0
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
    (the first match, shortest name first): static, by loop, and per lane."""
    text = subprocess.run([cuobjdump(), "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    funcs = parse(text)
    out = {}
    for name in names:
        match = sorted((f for f in funcs if name in f), key=len)
        if not match:
            out[name] = None
            continue
        instrs = funcs[match[0]]
        tree = loops(instrs)
        out[name] = {"function": match[0], "static": _mix(instrs), "loops": tree,
                     "per_lane": dynamic(instrs, tree, TRIPS[name]) if name in TRIPS else None}
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
