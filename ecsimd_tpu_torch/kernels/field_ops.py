"""Field-operation probe: the device field layer (``csrc/field_p256.cuh``)
run on digit planes by kernel C (``csrc/field_ops.cu``).

The device field layer replaces ``ecsimd_tpu/kernels/digits.py``, which has
no ``pallas_call`` of its own; the JAX package tests it through an
interpret-mode harness (``tests/test_kernels.py:_run_binop``). The probe is
that harness's counterpart: it lets a check on the card tell a field bug
from a formula bug. Its plain version is ``field.GFp``.
"""

from __future__ import annotations

import torch

from ecsimd_tpu.specs import P256_FIELD, FieldSpec
from ecsimd_tpu_torch.field import GFp
from ecsimd_tpu_torch.kernels import _build

KERNEL = _build.Kernel(
    symbol="ec_field_probe_p256",
    source="ecsimd_tpu_torch/csrc/field_ops.cu",
    replaces="tests/test_kernels.py:30 _run_binop (kernels/digits.py field ops)",
    n_pointers=3,
)

OPS = ("mul", "sqr", "add", "sub", "opposite")


def probe_plain(a, b, fs: FieldSpec = P256_FIELD):
    """(5, D, B) int32 planes of a*b, a^2, a+b, a-b, -a through GFp."""
    x, y = GFp(a, fs), GFp(b, fs)
    outs = (x * y, x.sqr(), x + y, x - y, x.opposite())
    return torch.stack([o.planes for o in outs])


def probe(a, b, fs: FieldSpec = P256_FIELD):
    """The same five results as ``probe_plain``: through kernel C for CUDA
    tensors, through ``probe_plain`` for CPU tensors."""
    if a.device.type == "cpu":
        return probe_plain(a, b, fs)
    _build.require_cuda(a, "field probe")
    if fs != P256_FIELD:
        raise NotImplementedError(
            f"{fs.name}: the CUDA field layer covers P-256 only (ROADMAP B0, other fields)"
        )
    shape = (fs.ndigits, a.shape[-1])
    _build.check_planes("a", a, shape, a.device)
    _build.check_planes("b", b, shape, a.device)
    out = torch.empty((len(OPS),) + shape, dtype=torch.int32, device=a.device)
    _build.launch(KERNEL, [a, b, out], shape[1])
    KERNEL.launches += 1
    return out
