"""Kernel-for-kernel A/B of this checkout's CUDA library against another
checkout's, on one card.

    python -m ecsimd_tpu_torch.bench.ab OTHER_CHECKOUT [--batch N] [--reps R]
        [--rounds K] [--only NAME,...]

Builds both libraries (the other from ``OTHER_CHECKOUT/ecsimd_tpu_torch/
csrc``, every ``.cu`` there, into ``build/ab/``), calls each kernel's
wrapper of this checkout once on inputs made from a seed (its launch is
captured: the kernel, its tensors, its batch and ints), then replays that
launch on both libraries with the same pointers. The outputs of the two
must agree word for word; the times are CUDA-event means over ``reps``
launches, taken in turns other, this, this, other, ``rounds`` times, so
that both sit on one card under one power limit. Prints one JSON line:
per kernel both times, their ratio, whether the outputs agreed, and each
library's ptxas report (registers, spill bytes) for it; then the card's
name and power limit. The kernels' C interface must be the same in both
checkouts.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import re
import subprocess
from pathlib import Path

import numpy as np
import torch

from ecsimd_tpu_torch import api, convert, x25519
from ecsimd_tpu_torch.bench import sass
from ecsimd_tpu_torch.field import GFp
from ecsimd_tpu_torch.kernels import _build, affine, comb, field_ops, ladder, mladder, window
from ecsimd_tpu_torch.kernels import glv as kglv
from ecsimd_tpu_torch.specs import P256, SECP256K1, W25519_FIELD, WEI25519

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


def _planes(ints, dev):
    return torch.from_numpy(convert.ints_to_planes(ints, 16)).to(dev)


def _below(rng, n, p, dev):
    return _planes([int.from_bytes(rng.bytes(40), "little") % p for _ in range(n)], dev)


def workloads(batch: int, dev) -> dict:
    """name -> a function that calls the wrapper(s) of one kernel once, on
    inputs of ``batch`` lanes made from ``SEED``."""
    rng = np.random.default_rng(SEED)
    s = _planes(_scalars(rng, batch, P256.order), dev)
    pt = api.scalar_mult_base(_planes(_scalars(rng, batch, P256.order), dev))
    limbs = comb.kernel_tables(P256, P256.gx, P256.gy, dev)
    _, _, nb = comb.device_tables(P256, P256.gx, P256.gy, dev)
    jac = comb.comb_planes(s, limbs, nb)
    a, b = _below(rng, batch, P256.p, dev), _below(rng, batch, P256.p, dev)

    k1 = SECP256K1
    s1 = _planes(_scalars(rng, batch, k1.order), dev)
    pt1 = api.scalar_mult_base(_planes(_scalars(rng, batch, k1.order), dev), k1)
    xm = GFp.from_classical(pt1.x, k1.field).planes.contiguous()
    ym = GFp.from_classical(pt1.y, k1.field).planes.contiguous()
    packed = kglv.pack_scalars(s1, k1).contiguous()
    limbs1 = comb.kernel_tables(k1, k1.gx, k1.gy, dev)
    _, _, nb1 = comb.device_tables(k1, k1.gx, k1.gy, dev)
    jac1 = comb.comb_planes(s1, limbs1, nb1, k1)
    a1, b1 = _below(rng, batch, k1.p, dev), _below(rng, batch, k1.p, dev)

    wf = W25519_FIELD
    kw = x25519._byte_planes([rng.bytes(32) for _ in range(batch)], True, dev)
    uw = _below(rng, batch, wf.p, dev)
    x2, z2 = mladder.mladder_planes(kw, uw, wf, x25519.A24, 255)
    limbsw = comb.kernel_tables(WEI25519, WEI25519.gx, WEI25519.gy, dev)
    _, _, nbw = comb.device_tables(WEI25519, WEI25519.gx, WEI25519.gy, dev)
    jacw = comb.comb_planes(kw, limbsw, nbw, WEI25519)
    aw, bw = _below(rng, batch, wf.p, dev), _below(rng, batch, wf.p, dev)

    chains = {f"comb_chains{c}" + (f"_unroll{u}" if u > 1 else ""): (c, u, False)
              for c, u in ((2, 1), (2, 2), (4, 1))}
    chains |= {f"comb_unroll{u}" + ("_strict" if st else ""): (1, u, st)
               for u in (2, 4) for st in (False, True)}
    return {
        "window": lambda: window.window_planes(s, pt.x, pt.y),
        "window_strict": lambda: window.window_planes(s, pt.x, pt.y, strict=True),
        "glv": lambda: kglv.glv_planes(packed, xm, ym, k1, strict=False),
        "glv_strict": lambda: kglv.glv_planes(packed, xm, ym, k1, strict=True),
        "ladder": lambda: ladder.ladder_planes(s, pt.x, pt.y),
        "comb": lambda: comb.comb_planes(s, limbs, nb),
        "comb_strict": lambda: comb.comb_planes(s, limbs, nb, strict=True),
        "comb_tree": lambda: comb.comb_tree_planes(s, limbs, nb),
        "comb_pipe": lambda: comb.comb_pipe_planes(s, limbs, nb),
        **{k: (lambda c=c, u=u, st=st: comb.comb_chains_planes(s, limbs, nb, P256, c, u, st))
           for k, (c, u, st) in chains.items()},
        "affine": lambda: affine.affine_planes(*jac),
        "field_probe": lambda: field_ops.probe(a, b),
        "comb_secp256k1": lambda: comb.comb_planes(s1, limbs1, nb1, k1),
        "comb_strict_secp256k1": lambda: comb.comb_planes(s1, limbs1, nb1, k1, strict=True),
        "affine_secp256k1": lambda: affine.affine_planes(*jac1, k1),
        "field_probe_secp256k1": lambda: field_ops.probe(a1, b1, k1.field),
        "mladder": lambda: mladder.mladder_planes(kw, uw, wf, x25519.A24, 255),
        "x25519_xdivz": lambda: mladder.xdivz(x2, z2),
        "comb_w25519": lambda: comb.comb_planes(kw, limbsw, nbw, WEI25519),
        "affine_w25519": lambda: affine.affine_planes(*jacw, WEI25519),
        "field_probe_w25519": lambda: field_ops.probe(aw, bw, wf),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", type=Path, help="the other checkout's root")
    ap.add_argument("--batch", type=int, default=524288)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--rounds", type=int, default=2, help="0: compare the outputs only")
    ap.add_argument("--only", default="", help="comma-separated kernel names")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the A/B times kernels on an NVIDIA GPU")
    dev = torch.device("cuda", 0)
    this = _build.library()
    csrc = (args.other / "ecsimd_tpu_torch" / "csrc").resolve()
    other = _build.compile_library(
        csrc, _build.BUILD_DIR.parent / "ab",
        sources=tuple(sorted(p.name for p in csrc.glob("*.cu"))),
        headers=tuple(sorted(p.name for p in csrc.glob("*.cuh"))))
    rep_this, rep_other = sass.ptxas(this.log), sass.ptxas(other.log)
    work = workloads(args.batch, dev)
    names = [n for n in args.only.split(",") if n] or list(work)
    stream = torch.cuda.current_stream(dev).cuda_stream
    results = []
    for name in names:
        launches = []
        with capture(launches):
            work[name]()
        torch.cuda.synchronize()
        fns = {lab: [(_build.entry(b.lib, k.symbol, k.n_pointers, k.n_ints), ts, n, ints)
                     for k, ts, n, ints in launches] for lab, b in (("this", this),
                                                                    ("other", other))}
        tensors = [t for _, ts, _, _ in launches for t in ts]

        def run(lab):
            for fn, ts, n, ints in fns[lab]:
                err = fn(*(t.data_ptr() for t in ts), n, *ints, stream)
                if err != 0:
                    raise RuntimeError(f"{name} ({lab}): CUDA error {err} at launch")

        outs = {}
        for lab in ("other", "this"):
            run(lab)
            torch.cuda.synchronize()
            outs[lab] = [t.clone() for t in tensors]
        exact = all(torch.equal(x, y) for x, y in zip(outs["this"], outs["other"]))
        del outs
        times = {"this": [], "other": []}
        for _ in range(args.rounds):
            for lab in ("other", "this", "this", "other"):
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                run(lab)
                start.record()
                for _ in range(args.reps):
                    run(lab)
                end.record()
                end.synchronize()
                times[lab].append(start.elapsed_time(end) / args.reps)
        ms = {lab: sum(v) / len(v) if v else None for lab, v in times.items()}
        ratio = ms["this"] / ms["other"] if args.rounds else None
        results.append({
            "name": name, "symbol": launches[0][0].symbol, "this_ms": ms["this"],
            "other_ms": ms["other"], "ratio": ratio, "exact": exact, "times": times,
            "ptxas_this": {k.symbol: sass.resources(rep_this, _kernel_part(k.symbol))
                           for k, *_ in launches},
            "ptxas_other": {k.symbol: sass.resources(rep_other, _kernel_part(k.symbol))
                            for k, *_ in launches},
        })
        timed = (f"this {ms['this']:.3f} ms, other {ms['other']:.3f} ms, ratio {ratio:.4f}, "
                 if args.rounds else "")
        print(f"{name}: {timed}exact {exact}", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({"card": smi, "batch": args.batch, "reps": args.reps,
                      "rounds": args.rounds, "kernels": results}))
    print(smi)
    if not all(r["exact"] for r in results):
        raise SystemExit("outputs differ between the two libraries")


def _kernel_part(symbol: str) -> str:
    """The C entry ec_<name>[_strict] -> the part of the kernel's mangled
    name that ptxas reports: <name>[_strict]_kernel, the strict word moved
    to where the sources put it."""
    base = symbol.removeprefix("ec_")
    m = re.fullmatch(r"comb_chains_(\w+?)_c(\d)u(\d)(_strict)?", base)
    if m:  # the template instantiation comb_chains_<curve>_kernel<c, u, strict>
        return f"comb_chains_{m[1]}_kernelILi{m[2]}ELi{m[3]}ELb{int(bool(m[4]))}E"
    if base.endswith("_strict"):
        stem = base.removesuffix("_strict")
        head, _, curve = stem.rpartition("_")
        return f"{head}_strict_{curve}_kernel"
    return f"{base}_kernel"


if __name__ == "__main__":
    main()
