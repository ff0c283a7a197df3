"""Build and load the CUDA kernels of ``ecsimd_tpu_torch/csrc``.

At first use, ``library()`` compiles every source in ``SOURCES`` with
``nvcc`` for Hopper (``sm_90a``) into one shared library with a plain C
interface, under ``build/ecsimd_tpu_torch/`` beside the package, and loads
it with ``ctypes``. The file name carries a hash of the sources and flags,
so an edited source builds anew. Nothing is built or imported on import:
the CPU tests import every module on machines without ``nvcc``.

Each C entry point launches on the stream it is given, allocates nothing
and returns ``cudaGetLastError()``; ``launch`` raises if that is not 0.
"""

from __future__ import annotations

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

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ecsimd_tpu_torch"
SOURCES = ("field_ops.cu", "ladder.cu", "comb.cu", "affine.cu")
HEADERS = ("field_p256.cuh", "coz_p256.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills per kernel, kept in the log
)


@dataclasses.dataclass
class Kernel:
    """One CUDA kernel of the port: its C entry point, its source, the TPU
    kernel it replaces, and the number of times it was launched."""

    symbol: str
    source: str
    replaces: str
    n_pointers: int
    launches: int = 0


@dataclasses.dataclass(frozen=True)
class Build:
    """A loaded kernel library, the seconds its build took (0.0 when it was
    already built) and the compiler's per-kernel resource report."""

    lib: ctypes.CDLL
    seconds: float
    log: str


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


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in HEADERS + SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


@functools.cache
def library() -> Build:
    """Build (if needed) and load the kernel library. Cached per process."""
    digest = _digest()
    so = BUILD_DIR / f"libecsimd_p256_{digest}.so"
    log = BUILD_DIR / f"libecsimd_p256_{digest}.log"
    seconds = 0.0
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # build under a temporary name and rename, so that a concurrent or
        # interrupted build never leaves a partial library under the final name
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *(str(CSRC / s) for s in SOURCES)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
        log.write_text(proc.stdout + proc.stderr)
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    return Build(lib, seconds, log.read_text() if log.exists() else "")


@functools.cache
def _entry(symbol: str, n_pointers: int):
    fn = getattr(library().lib, symbol)
    fn.argtypes = [ctypes.c_void_p] * n_pointers + [ctypes.c_int64, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def check_planes(name: str, t: torch.Tensor, shape: tuple[int, ...], device: torch.device):
    """Raise unless ``t`` is a contiguous int32 tensor of ``shape`` on ``device``."""
    if t.device != device or t.dtype != torch.int32 or tuple(t.shape) != shape:
        raise ValueError(
            f"{name}: expected int32 {shape} on {device}, got {t.dtype} "
            f"{tuple(t.shape)} on {t.device}"
        )
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def launch(kernel: Kernel, tensors: list[torch.Tensor], batch: int):
    """Call ``kernel``'s C entry on PyTorch's current stream of the tensors'
    card; raise if the launch was refused. The caller checks the tensors
    and counts the launch."""
    device = tensors[0].device
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _entry(kernel.symbol, kernel.n_pointers)(*(t.data_ptr() for t in tensors), batch, stream)
    if err != 0:
        raise RuntimeError(f"{kernel.symbol}: CUDA error {err} at launch")


def require_cuda(t: torch.Tensor, what: str):
    if t.device.type != "cuda":
        raise ValueError(f"{what}: the CUDA kernel takes CUDA tensors, got {t.device}")
