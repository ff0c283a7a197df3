"""Packaging of the PyTorch port: it imports neither JAX nor anything of the
JAX package, its CUDA sources are where the build step looks, its launch
counters start at 0, and every public path dispatches by the device of its
input tensors."""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

import ecsimd_tpu_torch
from ecsimd_tpu.specs import P256, SECP256K1
from ecsimd_tpu_torch.bench import roofline
from ecsimd_tpu_torch.curves.point import AffinePoint
from ecsimd_tpu_torch import ecdsa
from ecsimd_tpu_torch.kernels import _build, affine, comb, field_ops, glv, ladder, mladder, window
from tests.toy import CRAN64, TOY64, TOYGLV
from tests.torch_helpers import ints, port_spec, rand_ints, tplanes

ROOT = Path(__file__).resolve().parent.parent
PORT = Path(ecsimd_tpu_torch.__file__).resolve().parent
KERNELS = (*comb.KERNELS.values(), *ladder.KERNELS.values(), *window.KERNELS.values(),
           *field_ops.KERNELS.values(), *affine.KERNELS.values(), glv.KERNEL, glv.KERNEL_STRICT,
           mladder.KERNEL, mladder.KERNEL_XDIVZ, roofline.KERNEL, *comb.KERNELS_TREE.values(),
           *comb.KERNELS_PIPE.values(), *comb.KERNELS_GENERAL.values())
MODULES = sorted(
    "ecsimd_tpu_torch" + "".join("." + part for part in f.relative_to(PORT).with_suffix("").parts)
    for f in PORT.rglob("*.py")
)


def test_import_leaves_jax_out():
    code = (
        "import importlib, sys\n"
        f"for m in {[m.removesuffix('.__init__') for m in MODULES]!r}:\n"
        "    importlib.import_module(m)\n"
        "from ecsimd_tpu_torch.kernels import affine, comb, field_ops, glv, ladder, mladder, window\n"
        "from ecsimd_tpu_torch.bench import roofline\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'ecsimd_tpu')))\n"
        "print([k.launches for k in (*comb.KERNELS.values(), *ladder.KERNELS.values(),"
        " *window.KERNELS.values(), *field_ops.KERNELS.values(), *affine.KERNELS.values(),"
        " glv.KERNEL, glv.KERNEL_STRICT, mladder.KERNEL, mladder.KERNEL_XDIVZ, roofline.KERNEL,"
        " *comb.KERNELS_TREE.values(), *comb.KERNELS_PIPE.values(),"
        " *comb.KERNELS_GENERAL.values())])\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True, timeout=120).stdout.splitlines()
    assert out == ["[]", str([0] * len(KERNELS))]
    assert len(MODULES) > 20
    for m in ("ecsimd_tpu_torch.ecdsa", "ecsimd_tpu_torch.glv", "ecsimd_tpu_torch.kernels.glv",
              "ecsimd_tpu_torch.oracle.field", "ecsimd_tpu_torch.ops.mont",
              "ecsimd_tpu_torch.x25519", "ecsimd_tpu_torch.ops.crandall",
              "ecsimd_tpu_torch.kernels.mladder", "ecsimd_tpu_torch.bench.roofline",
              "ecsimd_tpu_torch.oracle.comb"):
        assert m in MODULES


def test_no_port_source_imports_jax():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py", ROOT / "tests/test_torch_cuda.py"]
    assert len(files) > 20
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                assert node.level == 0, f"{f}: relative import"
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in ("jax", "ecsimd_tpu"), f"{f} imports {n}"


def test_cuda_sources_listed_and_present():
    listed = set(_build.SOURCES + _build.HEADERS)
    on_disk = {p.name for p in _build.CSRC.iterdir() if p.suffix in (".cu", ".cuh")}
    assert listed == on_disk
    assert len({k.symbol for k in KERNELS}) == len(KERNELS)
    for k in KERNELS:
        assert (ROOT / k.source).is_file(), k.source
        assert Path(k.source).name in _build.SOURCES
        assert f'extern "C" int {k.symbol}(' in (ROOT / k.source).read_text(), k.symbol
        path, line = k.replaces.split()[0].split(":")
        assert (ROOT / path).is_file() and int(line) > 0, k.replaces
    assert _build.BUILD_DIR.parent.name == "build"


def test_launch_counters_start_at_zero_and_cpu_paths_launch_nothing():
    before = [k.launches for k in KERNELS]
    assert all(isinstance(n, int) for n in before)
    fs = port_spec(P256.field)
    a = rand_ints(np.random.default_rng(30), fs.p, 4, edges=[0, fs.p - 1])
    out = field_ops.probe(tplanes(a, 16), tplanes(a[::-1], 16))
    assert ints(out[0]) == [x * y % fs.p for x, y in zip(a, a[::-1])]
    assert ints(out[4]) == [(-x) % fs.p for x in a]
    comb.scalar_mult_base(tplanes([7, 9], 16), port_spec(P256))
    toy = port_spec(TOY64)
    g = [tplanes([v, v], 4) for v in (toy.gx, toy.gy)]
    for strict in (False, True):
        comb.scalar_mult_base(tplanes([7, 9], 4), toy, strict=strict)
        window.scalar_mult(tplanes([7, 9], 4), AffinePoint(*g, toy), strict=strict)
    # the comb's other schedules (kernels J, K, L on CUDA tensors)
    for kw in ({"chain": "tree"}, {"chain": "pipe"}, {"chains": 2}, {"chains": 4, "unroll": 2},
               {"unroll": 4, "strict": True}):
        comb.scalar_mult_base(tplanes([7, 9], 4), toy, **kw)
    # the secp256k1-shaped paths: CIOS probe, GLV chain, ECDSA on the toy GLV curve
    k1 = port_spec(SECP256K1.field)
    assert ints(field_ops.probe(tplanes(a, 16), tplanes(a, 16), k1)[2]) == [2 * x % k1.p for x in a]
    tg = port_spec(TOYGLV)
    gg = [tplanes([v, v], 2) for v in (tg.gx, tg.gy)]
    glv.scalar_mult(tplanes([7, 9], 2), AffinePoint(*gg, tg))
    r, s, ok = ecdsa.sign_planes(*(tplanes(v, 2) for v in ([1, 2], [3, 4], [5, 6])), tg)
    assert ok.tolist() == [1, 1] and r.device.type == "cpu"
    # the X25519-shaped paths: the x-only ladder and x / z on a toy Crandall
    # field, and the calibration chains
    cran = port_spec(CRAN64)
    x2, z2 = mladder.mladder_planes(tplanes([7, 9], 4), tplanes([3, 4], 4), cran, 5, 8)
    assert mladder.xdivz(x2, z2, cran).device.type == "cpu"
    roofline.calib(torch.ones(4, dtype=torch.int32), torch.ones(4, dtype=torch.int32), 4)
    assert [k.launches for k in KERNELS] == before
    assert field_ops.probe(tplanes(a, 16), tplanes(a, 16)).device.type == "cpu"
    assert torch.equal(out, field_ops.probe_plain(tplanes(a, 16), tplanes(a[::-1], 16)))
