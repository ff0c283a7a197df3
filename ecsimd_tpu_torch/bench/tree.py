"""Kernel M's reduction tree on the card: a profiler trace of whole trees
and the latency of one level.

    PYTHONPATH=CHECKOUT python ecsimd_tpu_torch/bench/tree.py [--curves p256,p521]
        [--batch N] [--calls C] [--small K] [--no-trace] [--out FILE]

Runs the ``ecsimd_tpu_torch`` of the checkout that ``PYTHONPATH`` names
(this one's single launch, or another's wrapper: the per-level tree of a
parent). For each curve:

- ``torch.profiler`` (CPU and CUDA activities) over ``--calls`` calls of
  ``kernels/batch_sum.batch_sum_planes`` on ``--batch`` lanes of points
  k_i G (Jacobian, internal form): each kernel M launch's device time in
  call order, the device's idle gap before each launch, the host's launch
  calls' start times, the call's device span and its host-clock time (each
  call ends in ``torch.cuda.synchronize()``); ``trace: false`` where the
  trace holds no device time (none with ``--no-trace``);
- the wrapper as a user calls it, the profiler off: ``--calls`` calls of
  ``batch_sum_planes``, each timed alone with CUDA events around it and
  with the host clock up to its ``torch.cuda.synchronize()``;
- where the wrapper takes a level count (``tree_planes``: one launch a
  tree), the first L levels of the tree in one launch, L = 1 ..
  ceil(log2 B), by CUDA events (mean of 20 launches after a warm-up), so
  that each level's share shows as a difference;
- the depth floor: whole trees at n = 2^k lanes, k = 1 .. ``--small``,
  each call timed alone with CUDA events (median of 30, the device idle
  before each), and the profiler's device time of one tree; the
  least-squares slopes in k are one level's latency through a complete
  add. ``depth_floor_ms`` is ceil(log2 B) times the profiler's slope, or,
  where the trace holds no device time and the tree is one launch, the
  events' slope: a lone launch's events hold the host's cost of that one
  launch, the same at every k, besides the tree (``depth_floor_from``
  says which; None for a per-level wrapper without a trace, whose events
  hold the host's cost of k launches).

Prints one JSON object (also written to ``--out``), then the card's name
and power limit as nvidia-smi gives them.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from ecsimd_tpu_torch import api, convert
from ecsimd_tpu_torch.curves.point import JacobianPoint
from ecsimd_tpu_torch.kernels import _build, batch_sum

SEED = 0x7EE5
CURVES = {tag: curve for curve, (tag, _) in _build.CURVE_TAGS.items()}


def points(curve, n, dev, rng):
    """n Jacobian points k_i G (z = 1, internal form) as (D, n) planes."""
    d = curve.field.ndigits
    nbytes = (curve.order.bit_length() + 7) // 8 + 8
    ks = [int.from_bytes(rng.bytes(nbytes), "little") % (curve.order - 1) + 1 for _ in range(n)]
    aff = api.scalar_mult_base(torch.from_numpy(convert.ints_to_planes(ks, d)).to(dev), curve)
    jac = JacobianPoint.from_affine(aff)
    return tuple(c.planes.contiguous() for c in (jac.x, jac.y, jac.z))


def _kernel_events(prof):
    """[(start_us, end_us)] of the kernel M launches in a trace, in order."""
    out = []
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and "batch_sum" in e.name:
            out.append((e.time_range.start, e.time_range.end))
    return sorted(out)


def _launch_calls(prof):
    """Host start times (us) of the CUDA runtime's launch calls, in order."""
    return sorted(e.time_range.start for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CPU
                  and e.name.startswith(("cudaLaunchKernel", "cudaLaunchCooperativeKernel")))


def trace(planes, curve, calls):
    """The profiler's view of ``calls`` whole trees (see the module doc)."""
    batch_sum.batch_sum_planes(*planes, curve)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    host_ms = []
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            t0 = time.perf_counter()
            batch_sum.batch_sum_planes(*planes, curve)
            torch.cuda.synchronize()
            host_ms.append((time.perf_counter() - t0) * 1e3)
    ev = _kernel_events(prof)
    if not ev:
        return {"trace": False, "host_ms": host_ms}
    per_call = max(1, len(ev) // calls)
    launches = _launch_calls(prof)
    out = []
    for c in range(0, len(ev), per_call):  # the trace may miss a call's first launch
        part = ev[c:c + per_call]
        out.append({
            "kernel_ms": [(e - s) / 1e3 for s, e in part],
            "gap_ms": [(part[i][0] - part[i - 1][1]) / 1e3 for i in range(1, len(part))],
            "span_ms": (part[-1][1] - part[0][0]) / 1e3,
            "busy_ms": sum(e - s for s, e in part) / 1e3,
        })
    issue = np.diff(launches[-per_call * calls:]) / 1e3 if len(launches) > 1 else []
    return {"trace": True, "launches_per_call": per_call, "calls": out, "host_ms": host_ms,
            "host_issue_interval_ms": [float(v) for v in issue[:per_call]]}


def lone_calls(planes, curve, calls):
    """``calls`` calls of ``batch_sum_planes``, the profiler off, each
    alone: ([CUDA-event ms], [host-clock ms up to its synchronize])."""
    batch_sum.batch_sum_planes(*planes, curve)
    torch.cuda.synchronize()
    event_ms, host_ms = [], []
    for _ in range(calls):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0 = time.perf_counter()
        start.record()
        batch_sum.batch_sum_planes(*planes, curve)
        end.record()
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        event_ms.append(start.elapsed_time(end))
    return event_ms, host_ms


def levels_ms(planes, curve):
    """CUDA-event ms of one launch of the tree's first L levels, L = 1 ..
    ceil(log2 B); None for a wrapper with no level count."""
    if not hasattr(batch_sum, "tree_planes"):
        return None
    out = []
    for lv in range(1, (planes[0].shape[1] - 1).bit_length() + 1):
        batch_sum.tree_planes(*planes, curve, levels=lv)
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(20):
            batch_sum.tree_planes(*planes, curve, levels=lv)
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / 20)
    return out


def depth_floor(planes, curve, small, batch, profile=True):
    """Trees at 2^k lanes, k = 1 .. small: the median CUDA-event ms of a
    lone call and (``profile``) the trace's device ms a tree; their slopes
    in k, and ceil(log2 batch) times the slope the module doc names."""
    ks = list(range(1, small + 1))
    event_ms, device_ms = [], []
    for k in ks:
        sub = tuple(p[:, :1 << k].contiguous() for p in planes)
        event_ms.append(float(np.median(lone_calls(sub, curve, 30)[0])))
        if not profile:
            continue
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            batch_sum.batch_sum_planes(*sub, curve)
            torch.cuda.synchronize()
        ev = _kernel_events(prof)
        device_ms.append(sum(e - s for s, e in ev) / 1e3 if ev else None)
    slope = lambda ys: float(np.polyfit(ks, ys, 1)[0])  # noqa: E731
    dev_slope = slope(device_ms) if device_ms and None not in device_ms else None
    one_launch = hasattr(batch_sum, "tree_planes")
    per_level = dev_slope if dev_slope is not None else slope(event_ms) if one_launch else None
    levels = (batch - 1).bit_length()
    return {"k": ks, "event_ms": event_ms, "device_ms": device_ms or None,
            "event_slope_ms": slope(event_ms), "device_slope_ms": dev_slope,
            "depth_floor_ms": None if per_level is None else levels * per_level,
            "depth_floor_from": ("profiler" if dev_slope is not None else
                                 "lone one-launch calls' events" if one_launch else None)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--curves", default="p256,p521")
    ap.add_argument("--batch", type=int, default=524288)
    ap.add_argument("--calls", type=int, default=3)
    ap.add_argument("--small", type=int, default=10)
    ap.add_argument("--no-trace", action="store_true",
                    help="skip the profiler: the wrapper's and the depth floor's events only")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the tree is traced on an NVIDIA GPU")
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    result = {"card": smi, "batch": args.batch, "torch": torch.__version__,
              "wrapper": batch_sum.__file__, "curves": {}}
    for tag in args.curves.split(","):
        curve = CURVES[tag]
        planes = points(curve, args.batch, dev, rng)
        event_ms, host_ms = lone_calls(planes, curve, args.calls)
        result["curves"][tag] = {"levels_ms": levels_ms(planes, curve),
                                 "tree": None if args.no_trace else trace(planes, curve,
                                                                          args.calls),
                                 "lone_calls": {"event_ms": event_ms, "host_ms": host_ms},
                                 "depth_floor": depth_floor(planes, curve, args.small,
                                                            args.batch, not args.no_trace)}
        del planes
    text = json.dumps(result)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    print(text)
    print(smi)


if __name__ == "__main__":
    main()
