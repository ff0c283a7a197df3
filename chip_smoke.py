"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU: build, verify, time.

    python3 chip_smoke.py

Drives ``ecsimd_tpu_torch`` (never JAX, nothing of the JAX package) through
its main paths at bench.py's deployment size, 524,288 lanes, with bench.py's
scalar draw (uniform mod n, edge scalars 1, 2, 5, n-2 first): batched
P-256 scalar multiplication — fixed-base k_i * G through the comb kernel,
variable-base k_i * P_i through the co-Z ladder and through the signed
window, each followed by the affine-conversion kernel — and batched ECDH.
Phases, one line each; any failed check raises and the script exits
non-zero:

  0. device: a CUDA card is required; prints its name, power limit and
     maximum SM clock.
  1. build: compiles every CUDA source of the port with nvcc (sm_90a), one
     process per source, and prints the build seconds and each kernel's
     registers, spills, stack frame and shared memory.
  2. field probe (kernel C) against the plain GFp: 65,536 lanes plus edge
     values, exact; 64 lanes also against Python ints.
  3. comb (kernel B) against comb_plain: Jacobian planes, exact, 65,536
     lanes; 512 lanes (edge scalars 1, 2, 5, n-2 first) against the oracle.
  4. ladder (kernel A) against group.scalar_mult the same way, lanes < 512
     carrying distinct points (i+1)G.
  5. affine conversion (kernel D) against the plain JacobianPoint.to_affine
     on phase 3's 65,536 comb results, one lane set to infinity; exact.
  6. the first main path through api.scalar_mult_base and api.scalar_mult
     at B = 524,288: launch counts, CUDA-event times of each kernel, its
     plain version and the end-to-end call, and 64 lanes of each result
     against the oracle.
  7. signed window (kernel E), plain and strict, against window_plain:
     exact on 65,536 lanes; 512 lanes with distinct points (i+1)G against
     the oracle (edge scalars, and n-1 for strict; the plain window's
     documented degenerate lanes, n-2 among them, excluded as bench.py
     excludes them).
  8. strict comb (kernel B strict) against strict comb_plain the same way,
     k = n-1 (result -G) included.
  9. the second main path at B = 524,288: api.scalar_mult_fast (both
     modes), api.scalar_mult_base(strict=True), and ECDH — two parties'
     derive_public_planes, then shared_secret_planes both ways, with a zero
     scalar, scalar = n, an off-curve peer and x = p in the batch: masks
     exact, d1*Q2 == d2*Q1 on every valid lane, 64 lanes against the
     oracle; launch counts; kernels E, E strict and B strict exact against
     their plain versions on the path's own inputs; CUDA-event times of
     each kernel, its plain version and the end-to-end call.

Inputs come from numpy.random.default_rng(SEED). The line before the last
is a JSON object with one entry per kernel; the last line is the device
summary ``{"ok": true, "device": {...}}``.
"""

import functools
import json
import subprocess
import sys
import time

import numpy as np
import torch

from ecsimd_tpu_torch import api, convert, ecdh
from ecsimd_tpu_torch.curves import group
from ecsimd_tpu_torch.curves.point import AffinePoint, JacobianPoint
from ecsimd_tpu_torch.field import GFp
from ecsimd_tpu_torch.kernels import _build, affine, comb, field_ops, ladder, window
from ecsimd_tpu_torch.oracle import coz
from ecsimd_tpu_torch.oracle import window as ow
from ecsimd_tpu_torch.specs import P256

SEED = 0xEC51
BATCH = 524288  # bench.py's deployment size
CHECK_LANES = 65536  # kernel against plain version, exact
ORACLE_LANES = 512  # against the Python-int oracle, as bench.py verifies
MAIN_ORACLE_LANES = 64
D = P256.field.ndigits
N, P = P256.order, P256.p
EDGE_SCALARS = [1, 2, 5, N - 2]
# CUDA names <name>_p256_kernel, as -Xptxas -v reports them
KERNELS = ("comb", "comb_strict", "ladder", "window", "window_strict", "affine", "field_probe")

# The least time the card could take for a kernel's work (bound_ms): the
# larger of its bytes over the memory rate and its 32-bit multiply-adds over
# the IMAD rate. Field multiplies (M) and squarings (S) per formula, counted
# in csrc/coz_p256.cuh and field_p256.cuh (fe_inv: 256 squarings and one
# multiply per set bit of p - 2). Every kernel is constant-time, so the count
# does not depend on the data.
FORMULA_MS = {
    "add_z2_1": (7, 4), "zdau": (9, 7), "tplu": (6, 7), "jac_dbl": (3, 5),
    "jac_add": (12, 4), "add_complete": (15, 9), "fe_inv": (128, 256),
    "affine_tail": (3, 1),  # z^-2, then x z^-2 and y z^-2 z^-1
}


def lane_ms(*terms):
    """(M, S) per lane for (count, formula) pairs."""
    return tuple(sum(n * FORMULA_MS[f][i] for n, f in terms) for i in (0, 1))


LANE_MS = {
    "comb": lane_ms((32, "add_z2_1")),
    "comb_strict": lane_ms((32, "add_complete")),
    "ladder": lane_ms((1, "tplu"), (254, "zdau"), (1, "add_z2_1")),
    "window": lane_ms((257, "jac_dbl"), (71, "jac_add"), (1, "add_z2_1")),
    "window_strict": lane_ms((257, "jac_dbl"), (7, "jac_add"), (65, "add_complete")),
    "affine": lane_ms((1, "fe_inv"), (1, "affine_tail")),
}
# 32 x 32 -> 64-bit products, two 32-bit multiply-adds each: a multiply has
# 8 x 8 products, a squaring 36 (8 squares, 28 cross products taken once)
IMADS_PER_MUL, IMADS_PER_SQR = 2 * 64, 2 * 36
PLANE_BYTES = D * 4  # one (16,) int32 digit column per lane
BYTES_PER_LANE = {  # each input plane read once, each output plane written once
    "comb": 4 * PLANE_BYTES, "comb_strict": 4 * PLANE_BYTES, "ladder": 6 * PLANE_BYTES,
    "window": 6 * PLANE_BYTES, "window_strict": 6 * PLANE_BYTES, "affine": 5 * PLANE_BYTES,
}
COMB_TABLE_BYTES = 32 * 256 * 2 * D * 4
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 peak memory bandwidth
IMAD_PER_SM_PER_CLOCK = 64  # CUDA C++ Programming Guide, compute capability 9.0
SMS = 132


def check(ok, what):
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def random_planes(rng, n):
    """(16, n) int32 digit planes of values below 0xFFFF * 2^240 < p."""
    planes = rng.integers(0, 1 << 16, size=(D, n), dtype=np.int64)
    planes[D - 1] = rng.integers(0, 0xFFFF, size=n)
    return planes.astype(np.int32)


def scalar_ints(rng, n, edges=EDGE_SCALARS):
    """bench.py's draw: uniform mod n (0 -> 1), edge scalars in the first lanes."""
    ks = [int.from_bytes(rng.bytes(32), "little") % N or 1 for _ in range(n)]
    ks[: len(edges)] = edges
    return ks


def scalar_planes(rng, n, edges=EDGE_SCALARS):
    return convert.ints_to_planes(scalar_ints(rng, n, edges), D)


@functools.cache
def multiples_of_g(n):
    """Affine (i+1)*G for i < n: oracle Jacobian adds, one batched inversion."""
    jacs = [(P256.gx, P256.gy, 1)]
    if n > 1:
        jacs.append(ow._jac_dbl(jacs[0], P256))
    for _ in range(n - 2):
        jacs.append(ow._jac_add(jacs[-1], jacs[0], P256))
    zinv = comb._batch_inv([z for _, _, z in jacs], P)
    return [(x * zi * zi % P, y * zi * zi * zi % P) for (x, y, _), zi in zip(jacs, zinv)]


def varbase_points(n, device):
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


def jacobian_affine_ints(planes, lanes):
    """Jacobian (x, y, z) planes -> affine int pairs via the plain to_affine."""
    jac = JacobianPoint(*(GFp(t[:, :lanes].contiguous(), P256.field) for t in planes), P256)
    return affine_ints(jac.to_affine(), lanes)


def oracle_base(ks):
    """k * G; (n-1) G = -G, outside the ladder oracle's domain."""
    return [(P256.gx, (P - P256.gy) % P) if k == N - 1
            else coz.scalar_mult_affine(k, P256.gx, P256.gy, P256) for k in ks]


def oracle_varbase(ks):
    """k_i * (i+1) * G, the points of varbase_points."""
    return oracle_base([k * (i + 1) % N for i, k in enumerate(ks)])


def window_degenerate(k, i):
    """True where the plain window's formulas degenerate for k * (i+1)G
    (the window oracle raises), as bench.py's _window_degenerate."""
    x, y = multiples_of_g(ORACLE_LANES)[i]
    try:
        ow.scalar_mult(k, (x, y, 1), P256)
        return False
    except ZeroDivisionError:
        return True


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
    """Registers, spills, stack frame and shared memory per kernel from
    nvcc's -Xptxas -v output."""
    out, current = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            current = next((k for k in KERNELS if f"{k}_p256_kernel" in line), None)
        if current is None:
            continue
        words = line.replace(",", "").split()
        if "stack frame" in line and "spill stores" in line:
            out.setdefault(current, {})["stack_frame_bytes"] = int(words[words.index("stack") - 2])
            out[current]["spill_stores"] = int(words[words.index("spill") - 2])
            out[current]["spill_loads"] = int(words[words.index("loads") - 3])
        if "Used" in line and "registers" in line:
            out.setdefault(current, {})["registers"] = int(words[words.index("registers") - 1])
            out[current]["smem_bytes"] = int(words[words.index("smem") - 2]) if "smem" in words else 0
    return out


def bound(name, lanes, sm_clock_mhz):
    """(bound_ms, bound_by) for ``lanes`` lanes of kernel ``name``."""
    muls, sqrs = LANE_MS[name]
    ops = (muls * IMADS_PER_MUL + sqrs * IMADS_PER_SQR) * lanes
    nbytes = BYTES_PER_LANE[name] * lanes + (COMB_TABLE_BYTES if name.startswith("comb") else 0)
    op_ms = ops / (IMAD_PER_SM_PER_CLOCK * SMS * sm_clock_mhz * 1e6) * 1e3
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return (op_ms, "operations") if op_ms >= byte_ms else (byte_ms, "bytes")


def nvidia_smi(query):
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def main():
    t_start = time.perf_counter()
    # -- phase 0: device ---------------------------------------------------------
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port's kernels run only on an NVIDIA GPU")
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi("name,power.limit")
    sm_clock_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    card = f"[{smi}]"
    print(f"phase 0 device: {name}; nvidia-smi: {smi}; max SM clock {sm_clock_mhz:.0f} MHz; "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    print(smi, flush=True)
    rng = np.random.default_rng(SEED)

    # -- phase 1: build ----------------------------------------------------------
    build = _build.library()
    res = resource_report(build.log)
    print(f"phase 1 build: {build.seconds:.1f} s nvcc ({len(_build.SOURCES)} sources in "
          f"parallel); ptxas {json.dumps(res)}", flush=True)
    for kname in KERNELS:
        check(kname in res and "registers" in res[kname], f"ptxas report for {kname}")

    # -- phase 2: field probe ----------------------------------------------------
    a = random_planes(rng, CHECK_LANES)
    b = random_planes(rng, CHECK_LANES)
    edges = [0, 1, P - 1, P - 2]
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
    check(ints[0] == [x * y % P for x, y in zip(ai, bi)], "probe mul vs ints")
    check(ints[1] == [x * x % P for x in ai], "probe sqr vs ints")
    check(ints[2] == [(x + y) % P for x, y in zip(ai, bi)], "probe add vs ints")
    check(ints[3] == [(x - y) % P for x, y in zip(ai, bi)], "probe sub vs ints")
    check(ints[4] == [(-x) % P for x in ai], "probe opposite vs ints")
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
    check(jacobian_affine_ints(comb_got, ORACLE_LANES) == want_base, "comb vs oracle")
    print(f"phase 3 comb: {CHECK_LANES} lanes exact vs comb_plain; {ORACLE_LANES} lanes "
          f"vs oracle (edge scalars 1, 2, 5, n-2)", flush=True)

    # -- phase 4: ladder ---------------------------------------------------------
    pts = varbase_points(CHECK_LANES, dev)
    got = ladder.ladder_planes(s_dev, pts.x, pts.y)
    t0 = time.perf_counter()
    plain = group.scalar_mult(s_dev, JacobianPoint.from_affine(pts))
    want = (plain.x.planes, plain.y.planes, plain.z.planes)
    torch.cuda.synchronize()
    ladder_plain_s = time.perf_counter() - t0
    ladder_check_err = max_abs_diff(got, want)
    check(ladder_check_err == 0, "ladder kernel == group.scalar_mult (Jacobian)")
    check(jacobian_affine_ints(got, ORACLE_LANES) == oracle_varbase(ks), "ladder vs oracle")
    print(f"phase 4 ladder: {CHECK_LANES} lanes exact vs group.scalar_mult "
          f"({ladder_plain_s:.1f} s plain); {ORACLE_LANES} lanes with points (i+1)G vs oracle",
          flush=True)

    # -- phase 5: affine conversion ----------------------------------------------
    jx, jy, jz = (t.clone() for t in comb_got)
    jz[:, -1] = 0  # a lane at infinity maps to (0, 0)
    got = affine.affine_planes(jx, jy, jz)
    plain = JacobianPoint(*(GFp(t, P256.field) for t in (jx, jy, jz)), P256).to_affine()
    torch.cuda.synchronize()
    affine_check_err = max_abs_diff(got, (plain.x, plain.y))
    check(affine_check_err == 0, "affine kernel == JacobianPoint.to_affine")
    check(not bool(got[0][:, -1].any() or got[1][:, -1].any()), "lane at infinity -> (0, 0)")
    check(affine_ints(AffinePoint(*got, P256), ORACLE_LANES) == want_base, "affine vs oracle")
    print(f"phase 5 affine: {CHECK_LANES} comb results exact vs JacobianPoint.to_affine "
          f"(one lane at infinity); {ORACLE_LANES} lanes vs oracle", flush=True)

    # -- phase 6: the first main path at B = 524,288 ------------------------------
    s_np = scalar_planes(rng, BATCH)
    scalars = torch.from_numpy(s_np).to(dev)
    points = varbase_points(BATCH, dev)
    counted = (comb.KERNEL, comb.KERNEL_STRICT, ladder.KERNEL, window.KERNEL,
               window.KERNEL_STRICT, affine.KERNEL, field_ops.KERNEL)
    for k in counted:
        k.launches = 0
    out_base = api.scalar_mult_base(scalars)
    out_var = api.scalar_mult(scalars, points)
    torch.cuda.synchronize()
    launches6 = {k.symbol: k.launches for k in counted}
    for k in (comb.KERNEL, ladder.KERNEL, affine.KERNEL):
        check(launches6[k.symbol] >= 1, f"main path launched {k.symbol}")
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
        lambda: JacobianPoint(*(GFp(t, P256.field) for t in jac_b), P256).to_affine())
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
    print(f"phase 6 main path B={BATCH}: launches {json.dumps(launches6)}; 64 lanes of each vs "
          f"oracle; k*G comb kernel {comb_ms:.3f} ms ({rate(comb_ms):.0f} mults/s), plain "
          f"{comb_plain_ms:.1f} ms; k*P ladder kernel {ladder_ms:.3f} ms "
          f"({rate(ladder_ms):.0f} mults/s), plain {ladder_plain_ms:.1f} ms; affine kernel "
          f"{affine_ms:.3f} ms, plain {affine_plain_ms:.1f} ms; api.scalar_mult_base "
          f"{base_api_ms:.3f} ms ({rate(base_api_ms):.0f} mults/s), api.scalar_mult "
          f"{var_api_ms:.3f} ms ({rate(var_api_ms):.0f} mults/s); plain times at the same "
          f"shape, one run each {card}", flush=True)

    # -- phase 7: signed window (kernel E), plain and strict ------------------------
    pts = varbase_points(CHECK_LANES, dev)
    window_check = {}
    for strict in (False, True):
        kname = "window_strict" if strict else "window"
        edges = EDGE_SCALARS + ([N - 1] if strict else [])
        s7_np = scalar_planes(rng, CHECK_LANES, edges)
        s7 = torch.from_numpy(s7_np).to(dev)
        got = window.window_planes(s7, pts.x, pts.y, strict=strict)
        err = max_abs_diff(got, window.window_plain(s7, pts.x, pts.y, P256, strict))
        check(err == 0, f"{kname} kernel == window_plain (Jacobian)")
        ks7 = convert.planes_to_ints(s7_np[:, :ORACLE_LANES])
        lanes = [i for i, k in enumerate(ks7) if strict or not window_degenerate(k, i)]
        check(strict or 3 not in lanes, "n-2 is a degenerate lane of the plain window")
        gaff, waff = jacobian_affine_ints(got, ORACLE_LANES), oracle_varbase(ks7)
        check([gaff[i] for i in lanes] == [waff[i] for i in lanes], f"{kname} vs oracle")
        window_check[kname] = err
        print(f"phase 7 {kname}: {CHECK_LANES} lanes exact vs window_plain; "
              f"{len(lanes)} of {ORACLE_LANES} lanes with points (i+1)G vs oracle "
              f"(edge scalars {'1, 2, 5, n-2, n-1' if strict else '1, 2, 5; degenerate lanes '}"
              f"{'' if strict else str(sorted(set(range(ORACLE_LANES)) - set(lanes)))})",
              flush=True)
    del got

    # -- phase 8: strict comb (kernel B strict) -----------------------------------
    s8_np = scalar_planes(rng, CHECK_LANES, EDGE_SCALARS + [N - 1])
    s8 = torch.from_numpy(s8_np).to(dev)
    got = comb.comb_planes(s8, tables, negbase_digits, strict=True)
    comb_strict_check_err = max_abs_diff(
        got, comb.comb_plain(s8, tables, P256, negbase, strict=True))
    check(comb_strict_check_err == 0, "strict comb kernel == strict comb_plain (Jacobian)")
    ks8 = convert.planes_to_ints(s8_np[:, :ORACLE_LANES])
    check(jacobian_affine_ints(got, ORACLE_LANES) == oracle_base(ks8), "strict comb vs oracle")
    check(jacobian_affine_ints(got, 5)[4] == (P256.gx, P - P256.gy), "strict comb (n-1) G = -G")
    print(f"phase 8 comb_strict: {CHECK_LANES} lanes exact vs strict comb_plain; "
          f"{ORACLE_LANES} lanes vs oracle (edge scalars 1, 2, 5, n-2, n-1)", flush=True)
    del got

    # -- phase 9: the second main path at B = 524,288 -----------------------------
    d1 = scalar_ints(rng, BATCH)
    d2 = scalar_ints(rng, BATCH, edges=[3, N - 2])
    bad = BATCH - 4  # lanes bad..bad+3: zero scalar, scalar = n, off-curve peer, x = p
    d1[bad], d1[bad + 1] = 0, N
    d1_dev = torch.from_numpy(convert.ints_to_planes(d1, D)).to(dev)
    d2_dev = torch.from_numpy(convert.ints_to_planes(d2, D)).to(dev)
    for k in counted:
        k.launches = 0
    fast = api.scalar_mult_fast(scalars, points)
    fast_strict = api.scalar_mult_fast(scalars, points, strict=True)
    base_strict = api.scalar_mult_base(scalars, strict=True)
    q1x, q1y, ok1 = ecdh.derive_public_planes(d1_dev)
    q2x, q2y, ok2 = ecdh.derive_public_planes(d2_dev)
    q2x_bad, q2y_bad = q2x.clone(), q2y.clone()
    y_off = (convert.planes_to_ints(q2y[:, bad + 2:bad + 3].cpu().numpy())[0] + 1) % P
    q2y_bad[:, bad + 2] = torch.from_numpy(convert.ints_to_planes([y_off], D)[:, 0])
    q2x_bad[:, bad + 3] = torch.from_numpy(convert.ints_to_planes([P], D)[:, 0])
    s12, ok12 = ecdh.shared_secret_planes(d1_dev, q2x_bad, q2y_bad)
    s21, ok21 = ecdh.shared_secret_planes(d2_dev, q1x, q1y)
    torch.cuda.synchronize()
    launches9 = {k.symbol: k.launches for k in counted}
    for k in (comb.KERNEL, comb.KERNEL_STRICT, window.KERNEL, window.KERNEL_STRICT, affine.KERNEL):
        check(launches9[k.symbol] >= 1, f"second main path launched {k.symbol}")

    ones = torch.ones(BATCH, dtype=torch.int32, device=dev)
    want1 = ones.clone()
    want1[bad:bad + 2] = 0
    check(torch.equal(ok1, want1), "derive_public mask: zero scalar and scalar = n rejected")
    check(torch.equal(ok2, ones), "derive_public mask: all valid")
    want12 = ones.clone()
    want12[bad:] = 0
    check(torch.equal(ok12, want12), "shared_secret mask: the four invalid lanes exactly")
    # Q1 on the two bad-scalar lanes is whatever the comb made of 0 and n;
    # the mask must say what an independent on-curve check of it says
    q1_bad = affine_ints(AffinePoint(q1x[:, bad:bad + 2], q1y[:, bad:bad + 2], P256), 2)
    host_ok = [int(x < P and y < P and (x, y) != (0, 0)
                   and (y * y - x**3 - P256.a * x - P256.b) % P == 0) for x, y in q1_bad]
    want21 = ones.clone()
    want21[bad:bad + 2] = torch.tensor(host_ok, dtype=torch.int32)
    check(torch.equal(ok21, want21), "shared_secret mask on the comb's outputs of 0 and n")
    both = (ok12 & ok21).bool()
    check(int(both.sum()) == BATCH - 4, "valid lanes")
    check(torch.equal(s12[:, both], s21[:, both]), "d1*Q2 == d2*Q1 on every valid lane")
    sx = convert.planes_to_ints(s21[:, :MAIN_ORACLE_LANES].cpu().numpy())
    check(sx == [x for x, _ in oracle_base([a * b % N for a, b in zip(d1, d2[:MAIN_ORACLE_LANES])])],
          "shared secrets vs oracle")
    ks = convert.planes_to_ints(s_np[:, :MAIN_ORACLE_LANES])
    fast_lanes = [i for i, k in enumerate(ks) if not window_degenerate(k, i)]
    check([affine_ints(fast, MAIN_ORACLE_LANES)[i] for i in fast_lanes]
          == [oracle_varbase(ks)[i] for i in fast_lanes], "scalar_mult_fast vs oracle")
    check(affine_ints(fast_strict, MAIN_ORACLE_LANES) == oracle_varbase(ks),
          "scalar_mult_fast(strict) vs oracle")
    check(affine_ints(base_strict, MAIN_ORACLE_LANES) == oracle_base(ks),
          "scalar_mult_base(strict) vs oracle")
    del fast, fast_strict, base_strict, s12, s21

    # the new kernels against their plain versions on the path's own inputs
    # (these launches come after the counts were read)
    window_err, window_plain_ms = {}, {}
    for strict, kname in ((False, "window"), (True, "window_strict")):
        window_plain_ms[kname], plain = time_once_ms(
            lambda: window.window_plain(scalars, points.x, points.y, P256, strict))
        window_err[kname] = max_abs_diff(
            window.window_planes(scalars, points.x, points.y, strict=strict), plain)
        check(window_err[kname] == 0, f"{kname} kernel == window_plain at B = 524,288")
        del plain
    comb_strict_plain_ms, plain = time_once_ms(
        lambda: comb.comb_plain(scalars, tables, P256, negbase, strict=True))
    comb_strict_err = max_abs_diff(
        comb.comb_planes(scalars, tables, negbase_digits, strict=True), plain)
    check(comb_strict_err == 0, "strict comb kernel == strict comb_plain at B = 524,288")
    del plain

    window_ms = time_ms(lambda: window.window_planes(scalars, points.x, points.y), 5)
    window_strict_ms = time_ms(
        lambda: window.window_planes(scalars, points.x, points.y, strict=True), 5)
    comb_strict_ms = time_ms(
        lambda: comb.comb_planes(scalars, tables, negbase_digits, strict=True), 20)
    fast_ms = time_ms(lambda: api.scalar_mult_fast(scalars, points), 5)
    fast_strict_ms = time_ms(lambda: api.scalar_mult_fast(scalars, points, strict=True), 5)
    base_strict_ms = time_ms(lambda: api.scalar_mult_base(scalars, strict=True), 10)
    derive_ms = time_ms(lambda: ecdh.derive_public_planes(d2_dev), 10)
    shared_ms = time_ms(lambda: ecdh.shared_secret_planes(d2_dev, q1x, q1y), 5)
    print(f"phase 9 second main path B={BATCH}: launches {json.dumps(launches9)}; masks exact "
          f"(4 invalid lanes), d1*Q2 == d2*Q1 on {BATCH - 4} lanes, 64 lanes of each result vs "
          f"oracle; E, E strict, B strict exact vs their plain versions; window kernel "
          f"{window_ms:.3f} ms ({rate(window_ms):.0f} mults/s), plain "
          f"{window_plain_ms['window']:.1f} ms; strict {window_strict_ms:.3f} ms, plain "
          f"{window_plain_ms['window_strict']:.1f} ms; strict comb kernel {comb_strict_ms:.3f} ms, "
          f"plain {comb_strict_plain_ms:.1f} ms; "
          f"api.scalar_mult_fast {fast_ms:.3f} ms, strict {fast_strict_ms:.3f} ms; "
          f"api.scalar_mult_base(strict) {base_strict_ms:.3f} ms; ecdh.derive_public_planes "
          f"{derive_ms:.3f} ms ({rate(derive_ms):.0f} keys/s), ecdh.shared_secret_planes "
          f"{shared_ms:.3f} ms ({rate(shared_ms):.0f} secrets/s); plain times at the same shape, "
          f"one run each {card}", flush=True)

    def entry(kernel, kname, err, ms, plain_ms):
        bound_ms, bound_by = bound(kname, BATCH, sm_clock_mhz)
        return {
            "name": kname, "route": "cuda", "source": kernel.source, "replaces": kernel.replaces,
            "launches": launches6[kernel.symbol] + launches9[kernel.symbol],
            "launches_by_path": {"phase6": launches6[kernel.symbol],
                                 "phase9": launches9[kernel.symbol]},
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None, "lanes": BATCH,
            **res[kname],
        }

    kernels = [
        entry(comb.KERNEL, "comb", max(comb_err, comb_check_err), comb_ms, comb_plain_ms),
        entry(comb.KERNEL_STRICT, "comb_strict", max(comb_strict_err, comb_strict_check_err),
              comb_strict_ms, comb_strict_plain_ms),
        entry(ladder.KERNEL, "ladder", max(ladder_err, ladder_check_err), ladder_ms,
              ladder_plain_ms),
        *(entry(k, kname, max(window_err[kname], window_check[kname]), ms,
                window_plain_ms[kname])
          for k, kname, ms in ((window.KERNEL, "window", window_ms),
                               (window.KERNEL_STRICT, "window_strict", window_strict_ms))),
        entry(affine.KERNEL, "affine", max(affine_err, affine_check_err), affine_ms,
              affine_plain_ms),
    ]
    probe = {
        "name": "field_probe", "route": "cuda", "source": field_ops.KERNEL.source,
        "replaces": field_ops.KERNEL.replaces, "lanes": CHECK_LANES, "max_abs_err": probe_err,
        "ms": probe_ms, "plain_ms": probe_plain_ms, **res["field_probe"],
    }
    api_ms = {"scalar_mult_base": base_api_ms, "scalar_mult": var_api_ms,
              "scalar_mult_fast": fast_ms, "scalar_mult_fast_strict": fast_strict_ms,
              "scalar_mult_base_strict": base_strict_ms,
              "ecdh.derive_public_planes": derive_ms, "ecdh.shared_secret_planes": shared_ms}
    print(json.dumps({"kernels": kernels, "checks": [probe], "card": smi,
                      "sm_clock_max_mhz": sm_clock_mhz, "batch": BATCH,
                      "build_s": build.seconds, "api_ms": api_ms,
                      "wall_s": time.perf_counter() - t_start}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                            "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
