"""Kernel E on P-384 and P-521 at fewer blocks an SM than it gets: how its
time follows the warps an SM.

    python -m ecsimd_tpu_torch.bench.occupancy [CHECKOUT] [--batch N]
        [--reps R] [--inline]

For each wide curve (and each checkout given, this one by default) it
builds a small library around the checkout's own ``window_<tag>.cu``
whose launcher takes a dynamic shared memory size, then launches both
modes of kernel E with extra shared memory so that 1, 2, ... blocks fit an
SM, up to the blocks its own table allows (each count read back from
``cudaOccupancyMaxActiveBlocksPerMultiprocessor``). ``--inline`` adds a
build with the field's ``fe_mul`` / ``fe_sqr`` forced inline, launched at
the full occupancy. Inputs are random residues below p made from a seed;
every variant's outputs must equal the first's. Times are CUDA-event
means over ``reps`` launches, taken in turns, forward then backward.
Prints each curve's ptxas report and times, one JSON line, and the card's
name and power limit. It reads both launch interfaces: the one that held
the whole table in shared memory (32 or 64 threads a block) and the split
table's (``launch_split``: a scratch and a persistent grid of 64-thread
blocks, here SMs x the blocks an SM of the run).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from ecsimd_tpu_torch import convert
from ecsimd_tpu_torch.bench import sass
from ecsimd_tpu_torch.kernels import _build
from ecsimd_tpu_torch.specs import P384, P521

SEED = 0x0CC
SM_SMEM = 233_472  # an SM's shared memory; a block reserves 1 KiB of it
BLOCK_SMEM = 232_448  # the most one block may take

_COMMON = """
extern "C" int sweep_occ(int strict, int smem) {{
  auto k = strict ? window_strict_{tag}_kernel : window_{tag}_kernel;
  cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int n = 0;
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, k, THREADS, smem);
  return e == cudaSuccess ? n : -(int)e;
}}
extern "C" int sweep_threads(void) {{ return THREADS; }}
extern "C" int sweep_base_smem(void) {{ return BASE_SMEM; }}
"""

# the whole table in shared memory: kernel(scalars, xs, ys, ax, ay, z, B)
_WHOLE = """
#define THREADS kThreads{TAG}
#define BASE_SMEM (table_bytes<{tag}::kWords, kThreads{TAG}>())
extern "C" int sweep_scratch_vecs(void) {{ return 0; }}
extern "C" int sweep_launch(const int32_t* s, const int32_t* x, const int32_t* y, int32_t* ax,
                            int32_t* ay, int32_t* z, int32_t* scratch, int64_t B, int64_t slots,
                            int strict, int smem, void* stream) {{
  auto k = strict ? window_strict_{tag}_kernel : window_{tag}_kernel;
  cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  k<<<(unsigned)((B + THREADS - 1) / THREADS), THREADS, smem, (cudaStream_t)stream>>>(
      s, x, y, ax, ay, z, B);
  return (int)cudaGetLastError();
}}
"""

# the split table: kernel(scalars, xs, ys, ax, ay, z, scratch, B, slots)
_SPLIT = """
#define THREADS kThreads
#define BASE_SMEM (Table{TAG}::kSmemBytes)
extern "C" int sweep_scratch_vecs(void) {{ return Table{TAG}::kScratchRows; }}
extern "C" int sweep_launch(const int32_t* s, const int32_t* x, const int32_t* y, int32_t* ax,
                            int32_t* ay, int32_t* z, int32_t* scratch, int64_t B, int64_t slots,
                            int strict, int smem, void* stream) {{
  auto k = strict ? window_strict_{tag}_kernel : window_{tag}_kernel;
  cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int64_t blocks = (B + THREADS - 1) / THREADS < slots / THREADS
                             ? (B + THREADS - 1) / THREADS : slots / THREADS;
  k<<<(unsigned)blocks, THREADS, smem, (cudaStream_t)stream>>>(s, x, y, ax, ay, z, scratch, B,
                                                              slots);
  return (int)cudaGetLastError();
}}
"""


def _source(csrc: Path, tag: str) -> str:
    split = "launch_split" in (csrc / f"window_{tag}.cu").read_text()
    body = '#include "window_{tag}.cu"\n' + (_SPLIT if split else _WHOLE) + _COMMON
    return body.format(tag=tag, TAG=tag.upper())


def _inline_copy(csrc: Path, into: Path) -> Path:
    """A copy of ``csrc`` whose wide fields inline fe_mul and fe_sqr: the
    field headers define EC_INLINE_FIELD_MULS first where their multiplies
    take that switch (``field_p384.cuh``'s EC_FIELD_MULS), else their
    ``__noinline__`` becomes ``__forceinline__`` (an older checkout)."""
    out = into / "csrc_inline"
    subprocess.run(["cp", "-r", str(csrc), str(out)], check=True)
    for name in ("field_p384.cuh", "field_p521.cuh"):
        f = out / name
        text = f.read_text()
        if text.count("EC_FIELD_MULS fe fe_") == 2:
            f.write_text("#define EC_INLINE_FIELD_MULS\n" + text)
            continue
        new = text
        for fn in ("fe_mul", "fe_sqr"):
            new = new.replace(f"static __device__ __noinline__ fe {fn}(",
                              f"static __device__ __forceinline__ fe {fn}(")
        if new.count("__forceinline__ fe fe_") < 2:
            raise RuntimeError(f"{name}: fe_mul / fe_sqr not found as __noinline__")
        f.write_text(new)
    return out


def build(jobs: dict, tmp: Path) -> dict:
    """{key: (csrc, tag)} -> {key: (ctypes library, ptxas report, seconds)},
    one nvcc each, all started together."""
    nvcc = _build._nvcc()
    procs, t0 = {}, time.perf_counter()
    for key, (csrc, tag) in jobs.items():
        name = "_".join(map(str, key))
        src = tmp / f"{name}.cu"
        src.write_text(_source(csrc, tag))
        so = tmp / f"{name}.so"
        cmd = [nvcc, *_build.NVCC_FLAGS, "-shared", "-I", str(csrc), "-o", str(so), str(src)]
        procs[key] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                           text=True))
    out = {}
    for key, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{log[-4000:]}")
        lib = ctypes.CDLL(str(so))
        lib.sweep_launch.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int64] * 2 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        out[key] = (lib, sass.ptxas(log), time.perf_counter() - t0)
    return out


def smem_for(lib, strict: int, blocks: int) -> int | None:
    """Dynamic shared memory that leaves ``blocks`` blocks an SM (the table's
    own at the full occupancy), or None."""
    base = lib.sweep_base_smem()
    full = lib.sweep_occ(strict, base)
    if blocks >= full:
        return base if blocks == full else None
    smem = max(base, min(BLOCK_SMEM, SM_SMEM // blocks - 1024) // 128 * 128)
    return smem if lib.sweep_occ(strict, smem) == blocks else None


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("checkouts", nargs="*", type=Path, default=[Path(".")])
    ap.add_argument("--batch", type=int, default=524288)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--inline", action="store_true", help="also time fe_mul / fe_sqr inlined")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the sweep times kernels on an NVIDIA GPU")
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    stream = torch.cuda.current_stream(dev).cuda_stream
    rng = np.random.default_rng(SEED)
    results = []
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        jobs = {}
        for i, root in enumerate(args.checkouts):
            csrc = (root / "ecsimd_tpu_torch" / "csrc").resolve()
            if args.inline:
                (tmp / str(i)).mkdir()
                inline = _inline_copy(csrc, tmp / str(i))
            for curve in (P384, P521):
                tag = _build.CURVE_TAGS[curve][0]
                jobs[(i, tag, "called")] = (csrc, tag)
                if args.inline:
                    jobs[(i, tag, "inline")] = (inline, tag)
        libs = build(jobs, tmp)
        for curve in (P384, P521):
            tag, d = _build.CURVE_TAGS[curve][0], curve.field.ndigits
            nbytes = 2 * d + 8
            planes = [torch.from_numpy(convert.ints_to_planes(
                [int.from_bytes(rng.bytes(nbytes), "little") % m for _ in range(args.batch)],
                d)).to(dev) for m in (curve.order, curve.p, curve.p)]
            outs = [torch.empty_like(planes[0]) for _ in range(3)]
            for strict in (0, 1):
                variants = []
                for (i, t, kind), (lib, rep, secs) in libs.items():
                    if t != tag:
                        continue
                    if kind == "inline":
                        variants.append((i, kind, lib.sweep_occ(strict, lib.sweep_base_smem()),
                                         lib.sweep_base_smem(), lib))
                        continue
                    for blocks in range(1, lib.sweep_occ(strict, lib.sweep_base_smem()) + 1):
                        smem = smem_for(lib, strict, blocks)
                        if smem is not None:
                            variants.append((i, kind, blocks, smem, lib))
                times = {v[:3]: [] for v in variants}
                scratch = {}

                def run(v):
                    i, kind, blocks, smem, lib = v
                    threads = lib.sweep_threads()
                    slots = sms * blocks * threads
                    vecs = lib.sweep_scratch_vecs()
                    key = (vecs, slots)
                    if key not in scratch:
                        scratch[key] = torch.empty((max(vecs, 1), slots, 4), dtype=torch.int32,
                                                   device=dev)
                    err = lib.sweep_launch(*(t.data_ptr() for t in (*planes, *outs)),
                                           scratch[key].data_ptr(), args.batch, slots, strict,
                                           smem, stream)
                    if err != 0:
                        raise RuntimeError(f"{tag} {v[:3]}: CUDA error {err} at launch")

                first = None
                for v in variants:
                    run(v)
                    torch.cuda.synchronize()
                    got = [o.clone() for o in outs]
                    if first is None:
                        first = got
                    elif not all(torch.equal(a, b) for a, b in zip(first, got)):
                        raise SystemExit(f"{tag} strict={strict} {v[:3]}: outputs differ")
                for order in (variants, variants[::-1]):
                    for v in order:
                        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                        start.record()
                        for _ in range(args.reps):
                            run(v)
                        end.record()
                        end.synchronize()
                        times[v[:3]].append(start.elapsed_time(end) / args.reps)
                for v in variants:
                    i, kind, blocks, smem, lib = v
                    ms = sum(times[v[:3]]) / len(times[v[:3]])
                    warps = blocks * lib.sweep_threads() // 32
                    mode = "_strict" if strict else ""
                    rep = sass.resources(libs[(i, tag, kind)][1], f"window{mode}_{tag}_kernel")
                    results.append({"checkout": str(args.checkouts[i]), "curve": curve.name,
                                    "strict": bool(strict), "variant": kind, "blocks": blocks,
                                    "warps": warps, "smem": smem, "ms": ms,
                                    "times": times[v[:3]], "ptxas": rep})
                    print(f"{args.checkouts[i]} {curve.name} window{mode} {kind}: {blocks} blocks "
                          f"({warps} warps) an SM, {smem} B shared a block: {ms:.3f} ms; "
                          f"ptxas {rep}", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({"card": smi, "batch": args.batch, "reps": args.reps, "rows": results}))
    print(smi)


if __name__ == "__main__":
    main()
