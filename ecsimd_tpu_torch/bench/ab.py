"""Kernel-for-kernel A/B of this checkout's CUDA library against another
checkout's, on one card.

    python -m ecsimd_tpu_torch.bench.ab OTHER_CHECKOUT [--batch N] [--reps R]
        [--rounds K] [--only NAME,...] [--sass] [--flags FLAG,...]

Builds both libraries (the other from ``OTHER_CHECKOUT/ecsimd_tpu_torch/
csrc``, every ``.cu`` there, into ``build/ab/``), calls each kernel's
wrapper of this checkout once on inputs made from a seed (its launch is
captured: the kernel, its tensors, its batch and ints), then replays that
launch on both libraries with the same pointers. The outputs of the two
must agree word for word; the times are CUDA-event means over ``reps``
launches, taken in turns other, this, this, other, ``rounds`` times, so
that both sit on one card under one power limit. A kernel the other
library lacks (one this checkout added) is timed on this library alone
and reported with ``other_ms`` and ``exact`` null.
``--sass`` also compares each kernel's SASS in the two libraries
(``cuobjdump -sass``, instruction for instruction): ``sass_equal``.
``--flags`` builds the other library with extra nvcc flags (say
``-maxrregcount=168``), and its word ``inline`` forces P-384's and
P-521's ``fe_mul`` / ``fe_sqr`` inline there (``bench/occupancy.py``'s
copy of the sources): so one kernel is timed against itself built
another way, the other checkout being this one or a copy of it with an
edited source (only the ``.cu`` files it holds are built).
Prints one JSON line: per kernel both times, their ratio, whether the
outputs agreed, and each library's ptxas report (registers, spill bytes)
for it; then the card's name and power limit.

Each library gets the arguments its own checkout's ``Kernel`` declares
(read from the other checkout by a Python process of its own): the first
``n_pointers`` of the captured tensors and the first ``n_ints`` of the
ints, so a kernel whose interface grew by trailing arguments (kernel E on
P-384 / P-521 gained a scratch and its slot count) is compared with
its older self.
Scratch tensors (a ``Kernel``'s last ``n_scratch`` pointers) are not
compared. Kernel M (``batch_sum``, a whole tree of ``--batch`` lanes a
launch; ``batch_sum_level``, its first level; with ``--only`` naming M's
alone, only M's inputs are made) is replayed on a checkout whose M ran one
level a launch (no ints)
as that checkout's wrapper ran it: one launch a level, each level's output
in tensors of its own, the last level's in the captured outputs.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from ecsimd_tpu_torch import api, convert, x25519
from ecsimd_tpu_torch.bench import occupancy, sass
from ecsimd_tpu_torch.field import GFp
from ecsimd_tpu_torch.kernels import _build, affine, batch_sum, comb, field_ops, ladder, mladder
from ecsimd_tpu_torch.kernels import window
from ecsimd_tpu_torch.kernels import glv as kglv
from ecsimd_tpu_torch.specs import P256, P384, P521, SECP256K1, W25519_FIELD, WEI25519

SEED = 0xAB06


@contextlib.contextmanager
def capture(into: list):
    """Record every launch the wrappers make (and make it, on this library)."""
    real = _build.launch

    def record(kernel, tensors, batch, *ints):
        real(kernel, tensors, batch, *ints)
        into.append((kernel, list(tensors), batch, ints))

    _build.launch = record
    try:
        yield
    finally:
        _build.launch = real


def _scalars(rng, n, order):
    nbytes = (order.bit_length() + 7) // 8 + 8
    return [int.from_bytes(rng.bytes(nbytes), "little") % (order - 1) + 1 for _ in range(n)]


def _planes(ints, dev, d=16):
    return torch.from_numpy(convert.ints_to_planes(ints, d)).to(dev)


def _below(rng, n, p, dev, d=16):
    nbytes = 40 if d == 16 else 8 + 4 * d
    return _planes([int.from_bytes(rng.bytes(nbytes), "little") % p for _ in range(n)], dev, d)


def _wide(batch: int, dev, rng) -> dict:
    """The workloads of kernels A, B, C, D, E, J, K and the generic L on
    P-384 and P-521."""
    out = {}
    for curve in (P384, P521):
        tag, d = _build.CURVE_TAGS[curve][0], curve.field.ndigits
        s = _planes(_scalars(rng, batch, curve.order), dev, d)
        pt = api.scalar_mult_base(_planes(_scalars(rng, batch, curve.order), dev, d), curve)
        mma = comb.mma_tables(curve, curve.gx, curve.gy, dev)
        _, _, nb = comb.device_tables(curve, curve.gx, curve.gy, dev)
        jac = comb.comb_planes(s, mma, nb, curve)
        a, b = _below(rng, batch, curve.p, dev, d), _below(rng, batch, curve.p, dev, d)
        out |= {
            f"ladder_{tag}": lambda s=s, pt=pt, c=curve: ladder.ladder_planes(s, pt.x, pt.y, c),
            f"window_{tag}": lambda s=s, pt=pt, c=curve: window.window_planes(s, pt.x, pt.y, c),
            f"window_strict_{tag}": lambda s=s, pt=pt, c=curve: window.window_planes(
                s, pt.x, pt.y, c, strict=True),
            f"comb_{tag}": lambda s=s, mm=mma, nb=nb, c=curve: comb.comb_planes(s, mm, nb, c),
            f"comb_strict_{tag}": lambda s=s, mm=mma, nb=nb, c=curve: comb.comb_planes(
                s, mm, nb, c, strict=True),
            f"affine_{tag}": lambda jac=jac, c=curve: affine.affine_planes(*jac, c),
            f"field_probe_{tag}": lambda a=a, b=b, c=curve: field_ops.probe(a, b, c.field),
            f"field_consts_{tag}": lambda c=curve: field_ops.constants(c.field, dev),
            f"comb_tree_{tag}": lambda s=s, mm=mma, nb=nb, c=curve: comb.comb_tree_planes(
                s, mm, nb, c),
            f"comb_pipe_{tag}": lambda s=s, mm=mma, nb=nb, c=curve: comb.comb_pipe_planes(
                s, mm, nb, c),
            **_general(tag, curve, s, mma, nb),
        }
    return out


# kernel L at comb.SCHEDULES_L: name (with the curve's tag but on P-256)
# -> (chains, unroll, strict)
SCHEDULES_L = {
    "comb_chains2": (2, 1, False), "comb_chains2_unroll2": (2, 2, False),
    "comb_chains4": (4, 1, False), "comb_unroll2": (1, 2, False), "comb_unroll4": (1, 4, False),
    "comb_unroll2_strict": (1, 2, True), "comb_unroll4_strict": (1, 4, True),
}


def _schedules(tag, curve, s, mma, nb) -> dict:
    """Kernel L at SCHEDULES_L on a 256-bit curve, and kernels J and K on
    one other than P-256."""
    sfx = "" if curve == P256 else f"_{tag}"
    out = {f"{k}{sfx}": (lambda c=c, u=u, st=st: comb.comb_general_planes(
        s, mma, nb, curve, c, u, st)) for k, (c, u, st) in SCHEDULES_L.items()}
    if curve != P256:
        out |= {f"comb_tree_{tag}": lambda: comb.comb_tree_planes(s, mma, nb, curve),
                f"comb_pipe_{tag}": lambda: comb.comb_pipe_planes(s, mma, nb, curve)}
    return out


def _general(tag, curve, s, mma, nb) -> dict:
    """Kernel L on P-384 or P-521: chains 2 (unroll 2 where npos allows it,
    else 1), and strict with one chain at unroll 2."""
    u = 2 if (curve.field.nbits // comb.W) % 4 == 0 else 1
    return {f"comb_general_{tag}": lambda: comb.comb_general_planes(s, mma, nb, curve, 2, u),
            f"comb_general_strict_{tag}": lambda: comb.comb_general_planes(
                s, mma, nb, curve, 1, 2, True)}


def _batch_sum(batch: int, dev) -> dict:
    """Kernel M alone on every curve: the whole tree (``batch_sum_<tag>``,
    ``batch_sum`` on P-256) and its first level (``batch_sum_level...``) on
    ``batch`` lanes of points k_i G from the comb (Jacobian, internal
    form)."""
    rng = np.random.default_rng(SEED)
    out = {}
    for curve, (tag, _) in _build.CURVE_TAGS.items():
        d, sfx = curve.field.ndigits, "" if curve == P256 else f"_{tag}"
        s = _planes(_scalars(rng, batch, curve.order), dev, d)
        mma = comb.mma_tables(curve, curve.gx, curve.gy, dev)
        _, _, nb = comb.device_tables(curve, curve.gx, curve.gy, dev)
        jac = comb.comb_planes(s, mma, nb, curve)
        out |= {f"batch_sum{sfx}": lambda jac=jac, c=curve: batch_sum.batch_sum_planes(*jac, c),
                f"batch_sum_level{sfx}": lambda jac=jac, c=curve: batch_sum.level_planes(*jac, c)}
    return out


def workloads(batch: int, dev) -> dict:
    """name -> a function that calls the wrapper(s) of one kernel once, on
    inputs of ``batch`` lanes made from ``SEED``."""
    rng = np.random.default_rng(SEED)
    s = _planes(_scalars(rng, batch, P256.order), dev)
    pt = api.scalar_mult_base(_planes(_scalars(rng, batch, P256.order), dev))
    mma = comb.mma_tables(P256, P256.gx, P256.gy, dev)
    _, _, nb = comb.device_tables(P256, P256.gx, P256.gy, dev)
    jac = comb.comb_planes(s, mma, nb)
    a, b = _below(rng, batch, P256.p, dev), _below(rng, batch, P256.p, dev)

    k1 = SECP256K1
    s1 = _planes(_scalars(rng, batch, k1.order), dev)
    pt1 = api.scalar_mult_base(_planes(_scalars(rng, batch, k1.order), dev), k1)
    xm = GFp.from_classical(pt1.x, k1.field).planes.contiguous()
    ym = GFp.from_classical(pt1.y, k1.field).planes.contiguous()
    packed = kglv.pack_scalars(s1, k1).contiguous()
    mma1 = comb.mma_tables(k1, k1.gx, k1.gy, dev)
    _, _, nb1 = comb.device_tables(k1, k1.gx, k1.gy, dev)
    jac1 = comb.comb_planes(s1, mma1, nb1, k1)
    a1, b1 = _below(rng, batch, k1.p, dev), _below(rng, batch, k1.p, dev)

    wf = W25519_FIELD
    kw = x25519._byte_planes([rng.bytes(32) for _ in range(batch)], True, dev)
    uw = _below(rng, batch, wf.p, dev)
    x2, z2 = mladder.mladder_planes(kw, uw, wf, x25519.A24, 255)
    mmaw = comb.mma_tables(WEI25519, WEI25519.gx, WEI25519.gy, dev)
    _, _, nbw = comb.device_tables(WEI25519, WEI25519.gx, WEI25519.gy, dev)
    jacw = comb.comb_planes(kw, mmaw, nbw, WEI25519)
    aw, bw = _below(rng, batch, wf.p, dev), _below(rng, batch, wf.p, dev)
    sw = _planes(_scalars(rng, batch, WEI25519.order), dev)
    ptw = api.scalar_mult_base(_planes(_scalars(rng, batch, WEI25519.order), dev), WEI25519)

    return {
        "window": lambda: window.window_planes(s, pt.x, pt.y),
        "window_strict": lambda: window.window_planes(s, pt.x, pt.y, strict=True),
        "glv": lambda: kglv.glv_planes(packed, xm, ym, k1, strict=False),
        "glv_strict": lambda: kglv.glv_planes(packed, xm, ym, k1, strict=True),
        "ladder": lambda: ladder.ladder_planes(s, pt.x, pt.y),
        "comb": lambda: comb.comb_planes(s, mma, nb),
        "comb_strict": lambda: comb.comb_planes(s, mma, nb, strict=True),
        "comb_tree": lambda: comb.comb_tree_planes(s, mma, nb),
        "comb_pipe": lambda: comb.comb_pipe_planes(s, mma, nb),
        "affine": lambda: affine.affine_planes(*jac),
        "field_probe": lambda: field_ops.probe(a, b),
        "comb_secp256k1": lambda: comb.comb_planes(s1, mma1, nb1, k1),
        "comb_strict_secp256k1": lambda: comb.comb_planes(s1, mma1, nb1, k1, strict=True),
        "affine_secp256k1": lambda: affine.affine_planes(*jac1, k1),
        "ladder_secp256k1": lambda: ladder.ladder_planes(s1, xm, ym, k1),
        "window_secp256k1": lambda: window.window_planes(s1, xm, ym, k1),
        "window_strict_secp256k1": lambda: window.window_planes(s1, xm, ym, k1, strict=True),
        "field_probe_secp256k1": lambda: field_ops.probe(a1, b1, k1.field),
        "mladder": lambda: mladder.mladder_planes(kw, uw, wf, x25519.A24, 255),
        "x25519_xdivz": lambda: mladder.xdivz(x2, z2),
        "comb_w25519": lambda: comb.comb_planes(kw, mmaw, nbw, WEI25519),
        "comb_strict_w25519": lambda: comb.comb_planes(kw, mmaw, nbw, WEI25519, strict=True),
        "affine_w25519": lambda: affine.affine_planes(*jacw, WEI25519),
        "ladder_w25519": lambda: ladder.ladder_planes(sw, ptw.x, ptw.y, WEI25519),
        "window_w25519": lambda: window.window_planes(sw, ptw.x, ptw.y, WEI25519),
        "window_strict_w25519": lambda: window.window_planes(sw, ptw.x, ptw.y, WEI25519,
                                                             strict=True),
        "field_probe_w25519": lambda: field_ops.probe(aw, bw, wf),
        **_schedules("p256", P256, s, mma, nb),
        **_schedules("secp256k1", k1, s1, mma1, nb1),
        **_schedules("w25519", WEI25519, kw, mmaw, nbw),
        **_wide(batch, dev, rng),
        **_batch_sum(batch, dev),
    }


_DECLARED = """
import gc, json, pkgutil, importlib
import ecsimd_tpu_torch
from ecsimd_tpu_torch.kernels import _build
for m in pkgutil.walk_packages(ecsimd_tpu_torch.__path__, "ecsimd_tpu_torch."):
    importlib.import_module(m.name)
print(json.dumps({k.symbol: [k.n_pointers, k.n_ints]
                  for k in gc.get_objects() if isinstance(k, _build.Kernel)}))
"""


def declared(checkout: Path) -> dict[str, tuple[int, int]]:
    """{C entry: (n_pointers, n_ints)} as ``checkout``'s own package
    declares its kernels, read by a Python process run in that checkout."""
    env = {**os.environ, "PYTHONPATH": str(checkout.resolve())}
    out = subprocess.run([sys.executable, "-c", _DECLARED], cwd=checkout, env=env,
                         capture_output=True, text=True, check=True, timeout=300).stdout
    return {k: tuple(v) for k, v in json.loads(out.splitlines()[-1]).items()}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", type=Path, help="the other checkout's root")
    ap.add_argument("--batch", type=int, default=524288)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--rounds", type=int, default=2, help="0: compare the outputs only")
    ap.add_argument("--only", default="", help="comma-separated kernel names")
    ap.add_argument("--sass", action="store_true", help="compare the kernels' SASS too")
    ap.add_argument("--flags", default="",
                    help="comma-separated extra nvcc flags for the other library; inline: "
                         "P-384's and P-521's fe_mul / fe_sqr inlined there")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the A/B times kernels on an NVIDIA GPU")
    dev = torch.device("cuda", 0)
    this = _build.library()
    csrc = (args.other / "ecsimd_tpu_torch" / "csrc").resolve()
    flags = [f for f in args.flags.split(",") if f]
    with tempfile.TemporaryDirectory() as tmp:
        if "inline" in flags:
            csrc = occupancy._inline_copy(csrc, Path(tmp))
        other = _build.compile_library(
            csrc, _build.BUILD_DIR.parent / "ab",
            sources=tuple(sorted(p.name for p in csrc.glob("*.cu"))),
            headers=tuple(sorted(p.name for p in csrc.glob("*.cuh"))),
            flags=tuple(f for f in flags if f != "inline"))
    other_args = declared(args.other)
    rep_this, rep_other = sass.ptxas(this.log), sass.ptxas(other.log)
    funcs = ({lab: _sass_functions(b.path) for lab, b in (("this", this), ("other", other))}
             if args.sass else None)
    names = [n for n in args.only.split(",") if n]
    work = (_batch_sum(args.batch, dev) if names and all(n.startswith("batch_sum") for n in names)
            else workloads(args.batch, dev))
    names = names or list(work)
    stream = torch.cuda.current_stream(dev).cuda_stream
    results = []
    for name in names:
        launches = []
        with capture(launches):
            work[name]()
        torch.cuda.synchronize()
        new = any(not hasattr(other.lib, k.symbol) for k, *_ in launches)
        labs = ("this",) if new else ("other", "this")
        counts = {"this": {k.symbol: (k.n_pointers, k.n_ints) for k, *_ in launches},
                  "other": other_args}
        fns = {}
        for lab, b in (("this", this), ("other", other)):
            if lab in labs:
                fns[lab] = []
                for k, ts, n, ints in launches:
                    n_ptr, n_int = counts[lab][k.symbol]
                    if n_ptr > len(ts) or n_int > len(ints):
                        raise RuntimeError(f"{name} ({lab}): {k.symbol} takes more arguments "
                                           f"than this checkout's wrapper gave it")
                    fn = _build.entry(b.lib, k.symbol, n_ptr, n_int)
                    if k.symbol.startswith("ec_batch_sum") and n_int == 0 and ints:
                        fns[lab] += [(fn, t, m, ()) for t, m in _per_level(ts, n, ints[0])]
                    else:
                        fns[lab].append((fn, ts[:n_ptr], n, ints[:n_int]))
        # the results: every tensor but the scratch
        tensors = [t for k, ts, _, _ in launches for t in ts[:len(ts) - k.n_scratch]]

        def run(lab):
            for fn, ts, n, ints in fns[lab]:
                err = fn(*(t.data_ptr() for t in ts), n, *ints, stream)
                if err != 0:
                    raise RuntimeError(f"{name} ({lab}): CUDA error {err} at launch")

        outs = {}
        for lab in labs:
            run(lab)
            torch.cuda.synchronize()
            outs[lab] = [t.clone() for t in tensors]
        exact = None if new else all(torch.equal(x, y) for x, y in zip(outs["this"], outs["other"]))
        del outs
        times = {"this": [], "other": []}
        for _ in range(args.rounds):
            for lab in ("other", "this", "this", "other"):
                if lab not in labs:
                    continue
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                run(lab)
                start.record()
                for _ in range(args.reps):
                    run(lab)
                end.record()
                end.synchronize()
                times[lab].append(start.elapsed_time(end) / args.reps)
        ms = {lab: sum(v) / len(v) if v else None for lab, v in times.items()}
        ratio = ms["this"] / ms["other"] if args.rounds and not new else None
        results.append({
            "name": name, "symbol": launches[0][0].symbol, "this_ms": ms["this"],
            "other_ms": ms["other"], "ratio": ratio, "exact": exact, "times": times,
            "ptxas_this": {k.symbol: sass.resources(rep_this, _kernel_part(k.symbol))
                           for k, *_ in launches},
            "ptxas_other": {k.symbol: sass.resources(rep_other, _kernel_part(k.symbol))
                            for k, *_ in launches},
            "sass_equal": None if new else _same_sass(funcs, launches),
        })
        if new:
            timed = f"this {ms['this']:.3f} ms (new: the other checkout lacks it), " if (
                args.rounds) else "new: the other checkout lacks it, "
        else:
            timed = (f"this {ms['this']:.3f} ms, other {ms['other']:.3f} ms, ratio {ratio:.4f}, "
                     if args.rounds else "")
        sass_note = "" if funcs is None else f", sass_equal {results[-1]['sass_equal']}"
        print(f"{name}: {timed}exact {exact}{sass_note}", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({"card": smi, "batch": args.batch, "reps": args.reps,
                      "rounds": args.rounds, "flags": flags, "kernels": results}))
    print(smi)
    if not all(r["exact"] is not False for r in results):
        raise SystemExit("outputs differ between the two libraries")


def _per_level(ts, n, levels):
    """Kernel M's launch on ``n`` lanes (x, y, z, ox, oy, oz, scratch) at
    ``levels`` levels as one launch a level of the interface before the
    tree was one launch: [(x, y, z, next x, y, z), lanes in]; the last
    level writes the launch's own outputs."""
    x, y, z, *outs = ts[:6]
    src, m, out = [x, y, z], n, []
    for lvl in range(levels):
        mo = m - m // 2
        dst = outs if lvl + 1 == levels else [
            torch.empty((x.shape[0], mo), dtype=torch.int32, device=x.device) for _ in range(3)]
        out.append((src + dst, m))
        src, m = dst, mo
    return out


def _sass_functions(lib: Path) -> dict:
    text = subprocess.run([sass.cuobjdump(), "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    return sass.parse(text)


def _same_sass(funcs, launches):
    """Whether every launched kernel has the same SASS in both libraries
    (None without --sass)."""
    if funcs is None:
        return None
    pairs = [(_sass_of(funcs["this"], k.symbol), _sass_of(funcs["other"], k.symbol))
             for k, *_ in launches]
    return all(a is not None and a == b for a, b in pairs)


def _sass_of(funcs: dict, symbol: str):
    """The (opcode, operands) list of the kernel of C entry ``symbol`` in
    ``funcs`` (the shortest function name that holds its part), or None."""
    pat = re.compile(r"(?<![A-Za-z_])" + re.escape(_kernel_part(symbol)))
    hits = sorted((f for f in funcs if pat.search(f)), key=len)
    return [(op, args) for _, op, args in funcs[hits[0]]] if hits else None


def _kernel_part(symbol: str) -> str:
    """The C entry ec_<name>[_strict] -> the part of the kernel's mangled
    name that ptxas reports: <name>[_strict]_kernel, the strict word moved
    to where the sources put it."""
    base = symbol.removeprefix("ec_")
    if base.endswith("_strict"):
        stem = base.removesuffix("_strict")
        head, _, curve = stem.rpartition("_")
        return f"{head}_strict_{curve}_kernel"
    return f"{base}_kernel"


if __name__ == "__main__":
    main()
