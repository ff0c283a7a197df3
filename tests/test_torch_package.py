"""Packaging of the PyTorch port: it imports no JAX, its CUDA sources are
where the build step looks, its launch counters start at 0, and every public
path dispatches by the device of its input tensors."""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

import ecsimd_tpu_torch
from ecsimd_tpu.specs import P256
from ecsimd_tpu_torch.kernels import _build, affine, comb, field_ops, ladder
from tests.torch_helpers import ints, rand_ints, tplanes

ROOT = Path(__file__).resolve().parent.parent
PORT = Path(ecsimd_tpu_torch.__file__).resolve().parent
KERNELS = (comb.KERNEL, ladder.KERNEL, field_ops.KERNEL, affine.KERNEL)


def test_import_leaves_jax_out():
    code = (
        "import sys\n"
        "import ecsimd_tpu_torch, ecsimd_tpu_torch.api\n"
        "import ecsimd_tpu_torch.kernels.comb, ecsimd_tpu_torch.kernels.ladder\n"
        "import ecsimd_tpu_torch.kernels.field_ops, ecsimd_tpu_torch.kernels.affine\n"
        "from ecsimd_tpu_torch.kernels import affine, comb, field_ops, ladder\n"
        "print(sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')))\n"
        "print([k.launches for k in (comb.KERNEL, ladder.KERNEL, field_ops.KERNEL,"
        " affine.KERNEL)])\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True, timeout=120).stdout.splitlines()
    assert out == ["[]", "[0, 0, 0, 0]"]


def test_no_port_source_imports_jax():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] != "jax", f"{f} imports {n}"
                assert not (n.startswith("ecsimd_tpu.") and n.split(".")[1] in (
                    "api", "field", "curves", "kernels", "ops", "parallel")), f"{f} imports {n}"


def test_cuda_sources_listed_and_present():
    listed = set(_build.SOURCES + _build.HEADERS)
    on_disk = {p.name for p in _build.CSRC.iterdir() if p.suffix in (".cu", ".cuh")}
    assert listed == on_disk
    for k in KERNELS:
        assert (ROOT / k.source).is_file(), k.source
        assert Path(k.source).name in _build.SOURCES
        path, line = k.replaces.split()[0].split(":")
        assert (ROOT / path).is_file() and int(line) > 0, k.replaces
    assert _build.BUILD_DIR.parent.name == "build"


def test_launch_counters_start_at_zero_and_cpu_paths_launch_nothing():
    before = [k.launches for k in KERNELS]
    assert all(isinstance(n, int) for n in before)
    fs = P256.field
    a = rand_ints(np.random.default_rng(30), fs.p, 4, edges=[0, fs.p - 1])
    out = field_ops.probe(tplanes(a, 16), tplanes(a[::-1], 16))
    assert ints(out[0]) == [x * y % fs.p for x, y in zip(a, a[::-1])]
    assert ints(out[4]) == [(-x) % fs.p for x in a]
    comb.scalar_mult_base(tplanes([7, 9], 16))
    assert [k.launches for k in KERNELS] == before
    assert field_ops.probe(tplanes(a, 16), tplanes(a, 16)).device.type == "cpu"
    assert torch.equal(out, field_ops.probe_plain(tplanes(a, 16), tplanes(a[::-1], 16)))
