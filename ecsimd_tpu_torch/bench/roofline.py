"""int32 throughput calibration on the card: kernel I (``csrc/calib.cu``),
its wrapper and its plain PyTorch version.

The port of the calibration half of ``ecsimd_tpu/bench/roofline.py``
(``_calib_kernel``, ``measure_vpu_ceiling``): 8 independent int32 chains
per element, each step a multiply, a mask, an add, a logical shift right
and an add, and the sum of the chains. ``measure_int32_ceiling`` replaces
``measure_vpu_ceiling``: it times kernel I with CUDA events over a grid
that fills every SM and reports int32 operations per second with the JAX
function's count (``OPS_PER_REP`` = 40 per element and step). The TPU
op counts of ``kernel_op_counts`` and ``roofline`` are not ported.
"""

from __future__ import annotations

import torch

from ecsimd_tpu_torch.kernels import _build

CHAINS = 8
OPS_PER_REP = CHAINS * 5  # 8 chains x (mul, and, add, shift, add)
IMADS_PER_REP = CHAINS  # one multiply per chain and step
THREADS_PER_SM = 2048  # Hopper's resident-thread limit per SM
U32 = (1 << 32) - 1

KERNEL = _build.Kernel(
    symbol="ec_calib",
    source="ecsimd_tpu_torch/csrc/calib.cu",
    replaces="ecsimd_tpu/bench/roofline.py:161 _calib_kernel",
    n_pointers=3,
    n_ints=1,
)


def calib_plain(a, b, reps: int):
    """The chains on int32 tensors of any shape, in int64 with every
    operation wrapped mod 2^32 explicitly (torch has no logical shift for
    int32, and int32 overflow is not defined in C++). Runs reps // 4 * 4
    steps, as the TPU kernel's 4-way unrolled loop does."""
    av, bv = a.to(torch.int64) & U32, b.to(torch.int64) & U32
    b_lo, b_hi = bv & 0xFFFF, bv >> 16
    accs = [(av + c) & U32 for c in range(CHAINS)]
    for _ in range(reps // 4 * 4):
        for c, acc in enumerate(accs):
            x = (acc * b_lo + (((acc * b_hi) & 0xFFFF) << 16)) & U32  # acc * b mod 2^32
            x = ((x & 0xFFFF) + av) & U32
            accs[c] = ((x >> 1) + bv) & U32
    s = sum(accs) & U32
    return torch.where(s >= 1 << 31, s - (1 << 32), s).to(torch.int32)


def calib(a, b, reps: int):
    """The chains through kernel I for CUDA tensors, ``calib_plain`` for
    CPU tensors; a, b: int32 tensors of one shape."""
    if a.device.type == "cpu":
        return calib_plain(a, b, reps)
    _build.require_cuda(a, "calib")
    a, b = a.contiguous(), b.contiguous()
    for name, t in (("a", a), ("b", b)):
        _build.check_planes(name, t, tuple(a.shape), a.device)
    out = torch.empty_like(a)
    _build.launch(KERNEL, [a, b, out], a.numel(), reps)
    KERNEL.count(a.numel(), reps)
    return out


def measure_int32_ceiling(reps: int = 1 << 16, iters: int = 8, device="cuda") -> dict:
    """Achievable int32 operations per second on one card (kernel I over
    ``THREADS_PER_SM`` threads on every SM), timed with CUDA events over
    ``iters`` launches after one warm-up. Returns the rates and the
    card's name."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError("measure_int32_ceiling times the card; got a CPU device")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n = sms * THREADS_PER_SM
    a = torch.ones(n, dtype=torch.int32, device=dev)
    b = torch.full((n,), 3, dtype=torch.int32, device=dev)
    calib(a, b, reps)
    torch.cuda.synchronize(dev)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        calib(a, b, reps)
    end.record()
    end.synchronize()
    seconds = start.elapsed_time(end) / 1e3
    steps = reps // 4 * 4 * n * iters
    return {
        "int32_ops_per_s": OPS_PER_REP * steps / seconds,
        "imad_per_s": IMADS_PER_REP * steps / seconds,
        "ms_per_launch": seconds * 1e3 / iters,
        "elements": n, "reps": reps // 4 * 4, "sms": sms,
        "device": torch.cuda.get_device_name(dev),
    }
