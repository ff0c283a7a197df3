"""Build and load the CUDA kernels of ``ecsimd_tpu_torch/csrc``.

At first use, ``library()`` compiles every source in ``SOURCES`` with
``nvcc`` for Hopper (``sm_90a``), one ``nvcc`` process per source, all
started together, and links the objects into one shared library with a
plain C interface, under ``build/ecsimd_tpu_torch/`` beside the package; it
loads it with ``ctypes``. The file name carries a hash of the sources and flags,
so an edited source builds anew. Nothing is built or imported on import:
the CPU tests import every module on machines without ``nvcc``.

Each C entry point launches on the stream it is given, allocates nothing
and returns ``cudaGetLastError()``; ``launch`` raises if that is not 0.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

from ecsimd_tpu_torch.specs import P256, P384, P521, SECP256K1, WEI25519

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ecsimd_tpu_torch"
SOURCES = ("field_ops.cu", "ladder.cu", "comb.cu", "affine.cu", "window.cu",
           "window_secp256k1.cu", "window_w25519.cu", "glv.cu", "mladder.cu", "calib.cu",
           "comb_tree.cu", "comb_pipe.cu", "ladder_p384.cu", "ladder_p521.cu", "window_p384.cu",
           "window_p521.cu", "comb_p384.cu", "comb_p521.cu", "comb_general.cu",
           "comb_general_secp256k1.cu", "comb_general_w25519.cu", "comb_general_p384.cu",
           "comb_general_p521.cu", "comb_pipe_p384.cu", "comb_pipe_p521.cu",
           "comb_tree_p384.cu", "comb_tree_p521.cu")
HEADERS = ("limbs.cuh", "limbs_ns.cuh", "mul256.cuh", "mul_wide.cuh", "field_p256.cuh",
           "field_secp256k1.cuh", "field_w25519.cuh", "field_p384.cuh", "field_p521.cuh",
           "jacobian.cuh", "coz.cuh", "dbl_am3.cuh", "coz_p256.cuh", "coz_secp256k1.cuh",
           "coz_w25519.cuh", "coz_p384.cuh", "coz_p521.cuh", "ladder_lane.cuh", "window.cuh",
           "window_lane.cuh", "window_table.cuh", "comb_stage.cuh", "comb_lane.cuh",
           "comb_tree_lane.cuh", "comb_pipe_lane.cuh", "smem.cuh", "comb_general.cuh",
           "comb_general_lane.cuh", "comb_tree_wide.cuh", "comb_tree_wide_lane.cuh",
           "comb_tree_schedule.cuh", "comb_mma.cuh", "comb_mma_lane.cuh", "affine_lane.cuh")
# curve -> (the tag of its kernels' C names, the curve as a kernel's
# ``replaces`` names it; none for P-256, the first curve ported)
CURVE_TAGS = {P256: ("p256", None), SECP256K1: ("secp256k1", "secp256k1"),
              WEI25519: ("w25519", "Wei25519"), P384: ("p384", "P-384"), P521: ("p521", "P-521")}
# the 256-bit curves: their kernel J and K instantiations in one source each
CURVES_256 = (P256, SECP256K1, WEI25519)
# the curves whose kernel A, B, D, E, J and K instantiations each have a
# source of their own (``<kernel>_<tag>.cu``), so that their builds run side
# by side
WIDE_CURVES = (P384, P521)
CURVES = CURVES_256 + WIDE_CURVES
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + (
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills per kernel, kept in the log
)


@dataclasses.dataclass
class Kernel:
    """One CUDA kernel of the port: its C entry point, its source, the TPU
    kernel it replaces, its arguments (``n_pointers`` tensors, the last
    ``n_scratch`` of them scratch that holds no result, then the batch and
    ``n_ints`` more int64 values), the number of times it was launched and
    those launches by lanes and ints (``shapes``: ``(batch, *ints)`` ->
    launches)."""

    symbol: str
    source: str
    replaces: str
    n_pointers: int
    n_ints: int = 0
    launches: int = 0
    n_scratch: int = 0
    shapes: dict = dataclasses.field(default_factory=dict)

    def count(self, batch: int, *ints: int):
        """Count one launch of ``batch`` lanes at ``ints``: each wrapper
        calls this where it launches the kernel, and nowhere else."""
        self.launches += 1
        key = (batch, *ints)
        self.shapes[key] = self.shapes.get(key, 0) + 1

    def reset(self):
        """Set the counts to 0."""
        self.launches = 0
        self.shapes.clear()


@dataclasses.dataclass(frozen=True)
class Build:
    """A loaded kernel library, its file, the seconds its build took (0.0
    when it was already built), the seconds each source's nvcc took (empty
    when it was already built) and the compiler's per-kernel resource
    report."""

    lib: ctypes.CDLL
    path: Path
    seconds: float
    log: str
    source_seconds: dict[str, float] = dataclasses.field(default_factory=dict)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is not None:
        candidate = Path(CUDA_HOME) / "bin" / "nvcc"
        if candidate.exists():
            return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return found


def _digest(csrc: Path, names, flags=()) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + tuple(flags)).encode())
    for name in names:
        h.update(name.encode())
        h.update((csrc / name).read_bytes())
    return h.hexdigest()[:16]


def compile_library(csrc: Path, build_dir: Path, sources=SOURCES, headers=HEADERS,
                    flags=()) -> Build:
    """Build (if needed) and load the library of ``sources`` in ``csrc``
    into ``build_dir``, the file named by a hash of the sources, the
    ``headers`` and the flags (``flags``: nvcc flags after NVCC_FLAGS)."""
    digest = _digest(csrc, tuple(headers) + tuple(sources), flags)
    so = build_dir / f"libecsimd_{digest}.so"
    log = build_dir / f"libecsimd_{digest}.log"
    seconds, source_seconds = 0.0, {}
    if not so.exists():
        build_dir.mkdir(parents=True, exist_ok=True)
        # build in a private directory and rename, so that a concurrent or
        # interrupted build never leaves a partial library under the final name
        with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
            nvcc = _nvcc()
            t0 = time.perf_counter()
            objs = [str(Path(tmp) / f"{src}.o") for src in sources]
            procs = [
                subprocess.Popen([nvcc, *NVCC_FLAGS, *flags, "-c", "-o", obj, str(csrc / src)],
                                 stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                for src, obj in zip(sources, objs)
            ]

            def finish(src, proc):
                out, err = proc.communicate()
                source_seconds[src] = time.perf_counter() - t0
                return src, proc, out, err

            with concurrent.futures.ThreadPoolExecutor(len(procs)) as pool:
                outs = list(pool.map(finish, sources, procs))
            failed = [f"{src}:\n{err}" for src, proc, _, err in outs if proc.returncode != 0]
            if failed:
                raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
            lib_tmp = str(Path(tmp) / so.name)
            link = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", lib_tmp, *objs],
                                  capture_output=True, text=True)
            if link.returncode != 0:
                raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stderr}")
            seconds = time.perf_counter() - t0
            log.write_text("".join(out + err for _, _, out, err in outs))
            os.replace(lib_tmp, so)
    lib = ctypes.CDLL(str(so))
    return Build(lib, so, seconds, log.read_text() if log.exists() else "", source_seconds)


@functools.cache
def library() -> Build:
    """Build (if needed) and load this package's kernel library. Cached per
    process."""
    return compile_library(CSRC, BUILD_DIR)


def entry(lib: ctypes.CDLL, symbol: str, n_pointers: int, n_ints: int):
    """The C entry point ``symbol`` of ``lib`` with its argument types set."""
    fn = getattr(lib, symbol)
    ints = [ctypes.c_int64] * (1 + n_ints)  # the batch, then the kernel's own ints
    fn.argtypes = [ctypes.c_void_p] * n_pointers + ints + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _entry(symbol: str, n_pointers: int, n_ints: int):
    return entry(library().lib, symbol, n_pointers, n_ints)


def check_planes(name: str, t: torch.Tensor, shape: tuple[int, ...], device: torch.device,
                 dtype: torch.dtype = torch.int32):
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on ``device``."""
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape:
        raise ValueError(
            f"{name}: expected {dtype} {shape} on {device}, got {t.dtype} "
            f"{tuple(t.shape)} on {t.device}"
        )
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def launch(kernel: Kernel, tensors: list[torch.Tensor], batch: int, *ints: int):
    """Call ``kernel``'s C entry on PyTorch's current stream of the tensors'
    card; raise if the launch was refused. The caller checks the tensors
    and counts the launch."""
    assert len(tensors) == kernel.n_pointers and len(ints) == kernel.n_ints, kernel.symbol
    device = tensors[0].device
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        fn = _entry(kernel.symbol, kernel.n_pointers, kernel.n_ints)
        err = fn(*(t.data_ptr() for t in tensors), batch, *ints, stream)
    if err != 0:
        raise RuntimeError(f"{kernel.symbol}: CUDA error {err} at launch")


def require_cuda(t: torch.Tensor, what: str):
    if t.device.type != "cuda":
        raise ValueError(f"{what}: the CUDA kernel takes CUDA tensors, got {t.device}")
