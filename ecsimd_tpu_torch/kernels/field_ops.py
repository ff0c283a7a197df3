"""Field-operation probe: the device field layers (``csrc/field_p256.cuh``,
``csrc/field_secp256k1.cuh``, ``csrc/field_w25519.cuh``,
``csrc/field_p384.cuh``, ``csrc/field_p521.cuh``) run on digit planes by
kernel C (``csrc/field_ops.cu``).

The device field layer replaces ``ecsimd_tpu/kernels/digits.py``, which has
no ``pallas_call`` of its own; the JAX package tests it through an
interpret-mode harness (``tests/test_kernels.py:_run_binop``). The probe is
that harness's counterpart: it lets a check on the card tell a field bug
from a formula bug. Its plain version is ``field.GFp``.
"""

from __future__ import annotations

import torch

from ecsimd_tpu_torch.specs import (P256_FIELD, P384_FIELD, P521_FIELD, SECP256K1_FIELD,
                                    W25519_FIELD, FieldSpec)
from ecsimd_tpu_torch.field import GFp
from ecsimd_tpu_torch.kernels import _build

KERNEL = _build.Kernel(
    symbol="ec_field_probe_p256",
    source="ecsimd_tpu_torch/csrc/field_ops.cu",
    replaces="tests/test_kernels.py:30 _run_binop (kernels/digits.py field ops)",
    n_pointers=3,
)
KERNEL_SECP256K1 = _build.Kernel(
    symbol="ec_field_probe_secp256k1",
    source="ecsimd_tpu_torch/csrc/field_ops.cu",
    replaces="tests/test_kernels.py:30 _run_binop (kernels/digits.py field ops, Montgomery)",
    n_pointers=3,
)
KERNEL_W25519 = _build.Kernel(
    symbol="ec_field_probe_w25519",
    source="ecsimd_tpu_torch/csrc/field_ops.cu",
    replaces="tests/test_kernels.py:30 _run_binop (kernels/digits.py field ops, Crandall)",
    n_pointers=3,
)
KERNEL_P384 = _build.Kernel(
    symbol="ec_field_probe_p384",
    source="ecsimd_tpu_torch/csrc/field_ops.cu",
    replaces="tests/test_kernels.py:30 _run_binop (kernels/digits.py field ops, P-384 Solinas)",
    n_pointers=3,
)
KERNEL_P521 = _build.Kernel(
    symbol="ec_field_probe_p521",
    source="ecsimd_tpu_torch/csrc/field_ops.cu",
    replaces="tests/test_kernels.py:30 _run_binop (kernels/digits.py field ops, P-521 Crandall)",
    n_pointers=3,
)
KERNELS = {P256_FIELD: KERNEL, SECP256K1_FIELD: KERNEL_SECP256K1, W25519_FIELD: KERNEL_W25519,
           P384_FIELD: KERNEL_P384, P521_FIELD: KERNEL_P521}

OPS = ("mul", "sqr", "add", "sub", "opposite")

# kernel C's constant-operand form on the P-384 and P-521 layers: the same
# operations on compile-time constants (1, 2, p - 1, 0), one lane
KERNELS_CONSTS = {
    fs: _build.Kernel(
        symbol=f"ec_field_consts_{fs.name}",
        source="ecsimd_tpu_torch/csrc/field_ops.cu",
        replaces=f"tests/test_kernels.py:30 _run_binop (kernels/digits.py field ops, {fs.name} "
                 "on compile-time constants)",
        n_pointers=1,
    )
    for fs in (P384_FIELD, P521_FIELD)
}
CONST_OPS = ("1 + (p-1)", "2 (p-1)", "1 - (p-1)", "0 - 1", "-0", "(p-1)(p-1)", "(p-1)^2",
             "1^2", "1 * 2", "dbl(p-1)")


def probe_plain(a, b, fs: FieldSpec = P256_FIELD):
    """(5, D, B) int32 planes of a*b, a^2, a+b, a-b, -a through GFp, the
    planes read as the field's internal form (Montgomery form for
    secp256k1)."""
    x, y = GFp(a, fs), GFp(b, fs)
    outs = (x * y, x.sqr(), x + y, x - y, x.opposite())
    return torch.stack([o.planes for o in outs])


def probe(a, b, fs: FieldSpec = P256_FIELD):
    """The same five results as ``probe_plain``: through kernel C for CUDA
    tensors, through ``probe_plain`` for CPU tensors."""
    if a.device.type == "cpu":
        return probe_plain(a, b, fs)
    _build.require_cuda(a, "field probe")
    kernel = KERNELS.get(fs)
    if kernel is None:
        raise NotImplementedError(
            f"{fs.name}: the CUDA field layers cover P-256, secp256k1, 2^255 - 19, P-384 and "
            "P-521")
    shape = (fs.ndigits, a.shape[-1])
    _build.check_planes("a", a, shape, a.device)
    _build.check_planes("b", b, shape, a.device)
    out = torch.empty((len(OPS),) + shape, dtype=torch.int32, device=a.device)
    _build.launch(kernel, [a, b, out], shape[1])
    kernel.count(shape[1])
    return out


def constants_plain(fs: FieldSpec, device="cpu"):
    """(10, D, 1) int32 planes of the ``CONST_OPS`` through GFp."""
    like = torch.zeros((fs.ndigits, 1), dtype=torch.int32, device=device)
    one, zero, two = (GFp.constant(v, fs, like) for v in (1, 0, 2))
    pm1 = one.opposite()
    outs = (pm1 + one, pm1 + pm1, one - pm1, zero - one, zero.opposite(), pm1 * pm1, pm1.sqr(),
            one.sqr(), one * two, pm1 + pm1)
    return torch.stack([o.planes for o in outs])


def constants(fs: FieldSpec, device="cuda"):
    """``constants_plain`` through kernel C's constant-operand form (P-384
    and P-521) for a CUDA ``device``, through ``constants_plain`` for the
    CPU."""
    device = torch.device(device)
    if device.type == "cpu":
        return constants_plain(fs)
    kernel = KERNELS_CONSTS.get(fs)
    if kernel is None:
        raise NotImplementedError(f"{fs.name}: the constant-operand probe covers P-384 and P-521")
    out = torch.empty((len(CONST_OPS), fs.ndigits, 1), dtype=torch.int32, device=device)
    _build.launch(kernel, [out], 1)
    kernel.count(1)
    return out
