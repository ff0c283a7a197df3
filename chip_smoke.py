"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU: build, verify, time.

    python3 chip_smoke.py

Drives ``ecsimd_tpu_torch`` (never JAX) through its main path — batched
P-256 scalar multiplication, fixed-base k_i * G through the comb kernel and
variable-base k_i * P_i through the co-Z ladder kernel, each followed by the
affine-conversion kernel — at bench.py's deployment size, 524,288 lanes,
with bench.py's scalar draw (uniform mod n, edge scalars 1, 2, 5, n-2
first). Phases, one line each; any failed check raises and the script exits
non-zero:

  0. device: a CUDA card is required; prints its name and power limit.
  1. build: compiles every CUDA source of the port with nvcc (sm_90a) and
     prints the build seconds and each kernel's registers and spills.
  2. field probe (kernel C) against the plain GFp: 65,536 lanes plus edge
     values, exact; 64 lanes also against Python ints.
  3. comb (kernel B) against comb_plain: Jacobian planes, exact, 65,536
     lanes; 512 lanes (edge scalars 1, 2, 5, n-2 first) against the oracle.
  4. ladder (kernel A) against group.scalar_mult the same way, lanes < 512
     carrying distinct points (i+1)G.
  5. affine conversion (kernel D) against the plain JacobianPoint.to_affine
     on phase 3's 65,536 comb results, one lane set to infinity; exact.
  6. the main path through api.scalar_mult_base and api.scalar_mult at
     B = 524,288: launch counts, CUDA-event times of each kernel, its plain
     version and the end-to-end call, mults/s, and 64 lanes of each result
     against the oracle.

Inputs come from numpy.random.default_rng(SEED). The line before the last
is a JSON object with one entry per kernel; the last line is the device
summary ``{"ok": true, "device": {...}}``.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

from ecsimd_tpu import convert
from ecsimd_tpu.oracle import coz
from ecsimd_tpu.oracle import window as ow
from ecsimd_tpu.specs import P256
from ecsimd_tpu_torch import api
from ecsimd_tpu_torch.curves import group
from ecsimd_tpu_torch.curves.point import AffinePoint, JacobianPoint
from ecsimd_tpu_torch.field import GFp
from ecsimd_tpu_torch.kernels import _build, affine, comb, field_ops, ladder

SEED = 0xEC51
BATCH = 524288  # bench.py's deployment size
CHECK_LANES = 65536  # kernel against plain version, exact
ORACLE_LANES = 512  # against the Python-int oracle, as bench.py verifies
MAIN_ORACLE_LANES = 64
D = P256.field.ndigits
EDGE_SCALARS = [1, 2, 5, P256.order - 2]
KERNELS = ("comb", "ladder", "affine", "field_probe")  # CUDA names: <name>_p256_kernel


def check(ok, what):
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def random_planes(rng, n):
    """(16, n) int32 digit planes of values below 0xFFFF * 2^240 < p."""
    planes = rng.integers(0, 1 << 16, size=(D, n), dtype=np.int64)
    planes[D - 1] = rng.integers(0, 0xFFFF, size=n)
    return planes.astype(np.int32)


def scalar_planes(rng, n):
    """bench.py's draw: uniform mod n (0 -> 1), edge scalars in the first lanes."""
    order = P256.order
    ks = [int.from_bytes(rng.bytes(32), "little") % order or 1 for _ in range(n)]
    ks[: len(EDGE_SCALARS)] = EDGE_SCALARS
    return convert.ints_to_planes(ks, D)


def multiples_of_g(n):
    """Affine (i+1)*G for i < n: oracle Jacobian adds, one batched inversion."""
    p = P256.p
    jacs = [(P256.gx, P256.gy, 1)]
    if n > 1:
        jacs.append(ow._jac_dbl(jacs[0], P256))
    for _ in range(n - 2):
        jacs.append(ow._jac_add(jacs[-1], jacs[0], P256))
    zinv = comb._batch_inv([z for _, _, z in jacs], p)
    return [(x * zi * zi % p, y * zi * zi * zi % p) for (x, y, _), zi in zip(jacs, zinv)]


def ladder_points(n, device):
    """Affine planes: lanes < ORACLE_LANES carry (i+1)G, the rest G."""
    pts = multiples_of_g(ORACLE_LANES)
    g = api.generator_batch(P256, n, device)
    xs, ys = g.x.clone(), g.y.clone()
    xs[:, :ORACLE_LANES] = torch.from_numpy(convert.ints_to_planes([x for x, _ in pts], D))
    ys[:, :ORACLE_LANES] = torch.from_numpy(convert.ints_to_planes([y for _, y in pts], D))
    return AffinePoint(xs, ys, P256)


def affine_ints(pt, lanes):
    x = convert.planes_to_ints(pt.x[:, :lanes].cpu().numpy())
    y = convert.planes_to_ints(pt.y[:, :lanes].cpu().numpy())
    return list(zip(x, y))


def oracle_base(ks):
    return [coz.scalar_mult_affine(k, P256.gx, P256.gy, P256) for k in ks]


def oracle_varbase(ks):
    """k_i * (i+1) * G, the points of ladder_points."""
    return oracle_base([k * (i + 1) % P256.order for i, k in enumerate(ks)])


def max_abs_diff(xs, ys):
    return max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max()) for a, b in zip(xs, ys))


def time_ms(fn, iters):
    """Mean milliseconds per call over ``iters`` calls after one warm-up,
    measured with CUDA events."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def time_once_ms(fn):
    """Milliseconds of one call, CUDA events, no warm-up (for slow plain runs)."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end), out


def resource_report(log):
    """Registers and spill bytes per kernel from nvcc's -Xptxas -v output."""
    out, current = {}, None
    for line in log.splitlines():
        for name in KERNELS:
            if "Compiling entry function" in line and f"{name}_p256_kernel" in line:
                current = name
        if current and "Used" in line and "registers" in line:
            regs = int(line.split("Used")[1].split("registers")[0])
            out.setdefault(current, {})["registers"] = regs
        if current and "spill stores" in line:
            words = line.replace(",", "").split()
            out.setdefault(current, {})["spill_stores"] = int(words[words.index("spill") - 2])
            out[current]["spill_loads"] = int(words[words.index("loads") - 3])
    return out


def main():
    # -- phase 0: device ---------------------------------------------------------
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port's kernels run only on an NVIDIA GPU")
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    card = f"[{smi}]"
    print(f"phase 0 device: {name}; nvidia-smi: {smi}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    rng = np.random.default_rng(SEED)

    # -- phase 1: build ----------------------------------------------------------
    build = _build.library()
    res = resource_report(build.log)
    print(f"phase 1 build: {build.seconds:.1f} s nvcc ({len(_build.SOURCES)} sources); "
          f"registers/spills {json.dumps(res)}", flush=True)
    for kname in KERNELS:
        check(kname in res, f"ptxas report for {kname}")

    # -- phase 2: field probe ----------------------------------------------------
    p = P256.p
    a = random_planes(rng, CHECK_LANES)
    b = random_planes(rng, CHECK_LANES)
    edges = [0, 1, p - 1, p - 2]
    pairs = [(x, y) for x in edges for y in edges]
    a[:, : len(pairs)] = convert.ints_to_planes([x for x, _ in pairs], D)
    b[:, : len(pairs)] = convert.ints_to_planes([y for _, y in pairs], D)
    a_dev, b_dev = torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)
    got = field_ops.probe(a_dev, b_dev)
    want = field_ops.probe_plain(a_dev, b_dev)
    torch.cuda.synchronize()
    probe_err = max_abs_diff(got, want)
    check(probe_err == 0, "field probe == plain GFp")
    ai, bi = convert.planes_to_ints(a[:, :64]), convert.planes_to_ints(b[:, :64])
    ints = [convert.planes_to_ints(got[k, :, :64].cpu().numpy()) for k in range(5)]
    check(ints[0] == [x * y % p for x, y in zip(ai, bi)], "probe mul vs ints")
    check(ints[1] == [x * x % p for x in ai], "probe sqr vs ints")
    check(ints[2] == [(x + y) % p for x, y in zip(ai, bi)], "probe add vs ints")
    check(ints[3] == [(x - y) % p for x, y in zip(ai, bi)], "probe sub vs ints")
    check(ints[4] == [(-x) % p for x in ai], "probe opposite vs ints")
    probe_ms = time_ms(lambda: field_ops.probe(a_dev, b_dev), 20)
    probe_plain_ms = time_ms(lambda: field_ops.probe_plain(a_dev, b_dev), 3)
    print(f"phase 2 field probe: {CHECK_LANES} lanes exact vs plain GFp and 64 vs ints; "
          f"kernel {probe_ms:.3f} ms, plain {probe_plain_ms:.3f} ms {card}", flush=True)

    # -- phase 3: comb -----------------------------------------------------------
    tables, negbase, negbase_digits = comb.device_tables(P256, P256.gx, P256.gy, dev)
    s_np = scalar_planes(rng, CHECK_LANES)
    s_dev = torch.from_numpy(s_np).to(dev)
    comb_got = comb.comb_planes(s_dev, tables, negbase_digits)
    want = comb.comb_plain(s_dev, tables, P256, negbase)
    torch.cuda.synchronize()
    comb_check_err = max_abs_diff(comb_got, want)
    check(comb_check_err == 0, "comb kernel == comb_plain (Jacobian)")
    ks = convert.planes_to_ints(s_np[:, :ORACLE_LANES])
    want_base = oracle_base(ks)
    fs = P256.field
    jac = JacobianPoint(*(GFp(t[:, :ORACLE_LANES].contiguous(), fs) for t in comb_got), P256)
    check(affine_ints(jac.to_affine(), ORACLE_LANES) == want_base, "comb vs oracle")
    print(f"phase 3 comb: {CHECK_LANES} lanes exact vs comb_plain; {ORACLE_LANES} lanes "
          f"vs oracle (edge scalars 1, 2, 5, n-2)", flush=True)

    # -- phase 4: ladder ---------------------------------------------------------
    pts = ladder_points(CHECK_LANES, dev)
    got = ladder.ladder_planes(s_dev, pts.x, pts.y)
    t0 = time.perf_counter()
    plain = group.scalar_mult(s_dev, JacobianPoint.from_affine(pts))
    want = (plain.x.planes, plain.y.planes, plain.z.planes)
    torch.cuda.synchronize()
    ladder_plain_s = time.perf_counter() - t0
    ladder_check_err = max_abs_diff(got, want)
    check(ladder_check_err == 0, "ladder kernel == group.scalar_mult (Jacobian)")
    jac = JacobianPoint(*(GFp(t[:, :ORACLE_LANES].contiguous(), fs) for t in got), P256)
    check(affine_ints(jac.to_affine(), ORACLE_LANES) == oracle_varbase(ks), "ladder vs oracle")
    print(f"phase 4 ladder: {CHECK_LANES} lanes exact vs group.scalar_mult "
          f"({ladder_plain_s:.1f} s plain); {ORACLE_LANES} lanes with points (i+1)G vs oracle",
          flush=True)

    # -- phase 5: affine conversion ----------------------------------------------
    jx, jy, jz = (t.clone() for t in comb_got)
    jz[:, -1] = 0  # a lane at infinity maps to (0, 0)
    got = affine.affine_planes(jx, jy, jz)
    plain = JacobianPoint(*(GFp(t, fs) for t in (jx, jy, jz)), P256).to_affine()
    torch.cuda.synchronize()
    affine_check_err = max_abs_diff(got, (plain.x, plain.y))
    check(affine_check_err == 0, "affine kernel == JacobianPoint.to_affine")
    check(not bool(got[0][:, -1].any() or got[1][:, -1].any()), "lane at infinity -> (0, 0)")
    check(affine_ints(AffinePoint(*got, P256), ORACLE_LANES) == want_base, "affine vs oracle")
    print(f"phase 5 affine: {CHECK_LANES} comb results exact vs JacobianPoint.to_affine "
          f"(one lane at infinity); {ORACLE_LANES} lanes vs oracle", flush=True)

    # -- phase 6: the main path at B = 524,288 -----------------------------------
    s_np = scalar_planes(rng, BATCH)
    scalars = torch.from_numpy(s_np).to(dev)
    points = ladder_points(BATCH, dev)
    path = (comb.KERNEL, ladder.KERNEL, affine.KERNEL, field_ops.KERNEL)
    for k in path:
        k.launches = 0
    out_base = api.scalar_mult_base(scalars)
    out_var = api.scalar_mult(scalars, points)
    torch.cuda.synchronize()
    launches = {k.symbol: k.launches for k in path}
    for k in path[:3]:
        check(launches[k.symbol] >= 1, f"main path launched {k.symbol}")
    for out in (out_base, out_var):
        check(out.x.shape == (D, BATCH) and out.y.shape == (D, BATCH), "output shape")
        check(out.x.dtype == torch.int32, "output dtype")
        check(bool(((out.x >= 0) & (out.x < 1 << 16)).all()), "output digits in range")
    ks = convert.planes_to_ints(s_np[:, :MAIN_ORACLE_LANES])
    check(affine_ints(out_base, MAIN_ORACLE_LANES) == oracle_base(ks), "main path k*G vs oracle")
    check(affine_ints(out_var, MAIN_ORACLE_LANES) == oracle_varbase(ks), "main path k*P vs oracle")

    # each kernel against its plain version at the main path's shape
    comb_ms = time_ms(lambda: comb.comb_planes(scalars, tables, negbase_digits), 20)
    comb_plain_ms, comb_plain_out = time_once_ms(
        lambda: comb.comb_plain(scalars, tables, P256, negbase))
    jac_b = comb.comb_planes(scalars, tables, negbase_digits)
    comb_err = max_abs_diff(jac_b, comb_plain_out)
    check(comb_err == 0, "comb kernel == comb_plain at B = 524,288")
    del comb_plain_out
    affine_ms = time_ms(lambda: affine.affine_planes(*jac_b), 20)
    affine_plain_ms, plain = time_once_ms(
        lambda: JacobianPoint(*(GFp(t, fs) for t in jac_b), P256).to_affine())
    affine_err = max_abs_diff(affine.affine_planes(*jac_b), (plain.x, plain.y))
    check(affine_err == 0, "affine kernel == JacobianPoint.to_affine at B = 524,288")
    del plain, jac_b
    ladder_ms = time_ms(lambda: ladder.ladder_planes(scalars, points.x, points.y), 5)
    ladder_plain_ms, plain = time_once_ms(
        lambda: group.scalar_mult(scalars, JacobianPoint.from_affine(points)))
    ladder_err = max_abs_diff(
        ladder.ladder_planes(scalars, points.x, points.y),
        (plain.x.planes, plain.y.planes, plain.z.planes))
    check(ladder_err == 0, "ladder kernel == group.scalar_mult at B = 524,288")
    del plain
    base_api_ms = time_ms(lambda: api.scalar_mult_base(scalars), 10)
    var_api_ms = time_ms(lambda: api.scalar_mult(scalars, points), 5)
    rate = lambda ms: BATCH / (ms / 1e3)  # noqa: E731
    print(f"phase 6 main path B={BATCH}: launches {json.dumps(launches)}; 64 lanes of each vs "
          f"oracle; k*G comb kernel {comb_ms:.3f} ms ({rate(comb_ms):.0f} mults/s), plain "
          f"{comb_plain_ms:.1f} ms; k*P ladder kernel {ladder_ms:.3f} ms "
          f"({rate(ladder_ms):.0f} mults/s), plain {ladder_plain_ms:.1f} ms; affine kernel "
          f"{affine_ms:.3f} ms, plain {affine_plain_ms:.1f} ms; api.scalar_mult_base "
          f"{base_api_ms:.3f} ms ({rate(base_api_ms):.0f} mults/s), api.scalar_mult "
          f"{var_api_ms:.3f} ms ({rate(var_api_ms):.0f} mults/s); plain times at the same "
          f"shape, one run each {card}", flush=True)

    def entry(kernel, kname, err, ms, plain_ms):
        return {
            "name": kname, "route": "cuda", "source": kernel.source, "replaces": kernel.replaces,
            "launches": launches[kernel.symbol], "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, **res[kname],
        }

    kernels = [
        entry(comb.KERNEL, "comb", max(comb_err, comb_check_err), comb_ms, comb_plain_ms),
        entry(ladder.KERNEL, "ladder", max(ladder_err, ladder_check_err), ladder_ms,
              ladder_plain_ms),
        entry(affine.KERNEL, "affine", max(affine_err, affine_check_err), affine_ms,
              affine_plain_ms),
    ]
    probe = {
        "name": "field_probe", "route": "cuda", "source": field_ops.KERNEL.source,
        "replaces": field_ops.KERNEL.replaces, "lanes": CHECK_LANES, "max_abs_err": probe_err,
        "ms": probe_ms, "plain_ms": probe_plain_ms, **res["field_probe"],
    }
    print(json.dumps({"kernels": kernels, "checks": [probe], "card": smi, "batch": BATCH,
                      "build_s": build.seconds, "api_ms": {"scalar_mult_base": base_api_ms,
                                                           "scalar_mult": var_api_ms}}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                            "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
