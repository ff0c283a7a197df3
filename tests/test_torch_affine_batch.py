"""Kernel D's batch inversion as a Python-int model of the CUDA lanes
(ecsimd_tpu_torch/csrc/affine_lane.cuh), with no card: the model follows
the kernel's schedule (thread t of a block of T threads takes lanes base +
t + j T, j < G; prefix products forward; one inversion a thread, or one a
block: each warp's shuffled prefix and suffix products, one thread
inverting the block's product and unwinding it over the warps; two
multiplies a lane back; zero and past-the-end lanes enter as 1), at small
T, G and warp, and is held against the JAX package's
JacobianPoint.to_affine, the port's plain to_affine and the Python-int
oracle on TOY64 and P-256 (at most 16 lanes). The inversion chains of the
field headers are read from the sources and run on ints. Tolerance: exact."""

import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from ecsimd_tpu.curves.point import JacobianPoint as JJacobian
from ecsimd_tpu.field import GFp as JGFp
from ecsimd_tpu.oracle import coz as ocoz
from ecsimd_tpu.specs import P256
from ecsimd_tpu_torch import specs as tspecs
from ecsimd_tpu_torch.curves.point import JacobianPoint
from ecsimd_tpu_torch.field import GFp
from tests.toy import TOY64
from tests.torch_helpers import ints, multiples, planes, port_spec, rand_ints, tplanes

CSRC = Path(__file__).resolve().parent.parent / "ecsimd_tpu_torch" / "csrc"


# -- kernel D ----------------------------------------------------------------------

def block_inverse(totals, p, inv, warp):
    """affine_lane.cuh's block_inverse on a block of len(totals) threads,
    ``warp`` a warp: in each warp, Kogge-Stone inclusive prefix and suffix
    products (a lane whose source lies outside the warp multiplies by 1);
    the warps' products Q_v; one thread's prefix products of them, one
    inversion of the block's product and the unwinding into each Q_v^-1;
    then each lane's Q_v^-1 (t_0 .. t_{l-1}) (t_{l+1} .. t_{w-1})."""
    pres, sufs = [], []
    for w0 in range(0, len(totals), warp):
        pre, suf = list(totals[w0:w0 + warp]), list(totals[w0:w0 + warp])
        off = 1
        while off < warp:
            pre = [pre[l] * (pre[l - off] if l >= off else 1) % p for l in range(warp)]
            suf = [suf[l] * (suf[l + off] if l + off < warp else 1) % p for l in range(warp)]
            off *= 2
        pres.append(pre)
        sufs.append(suf)
    q = [pre[-1] for pre in pres]
    qp, acc = [], q[0]
    for v in range(1, len(q)):
        qp.append(acc)
        acc = acc * q[v] % p
    cur = inv(acc)
    q_inv = [None] * len(q)
    for v in range(len(q) - 1, 0, -1):
        q_inv[v] = cur * qp[v - 1] % p
        cur = cur * q[v] % p
    q_inv[0] = cur
    out = []
    for v, (pre, suf) in enumerate(zip(pres, sufs)):
        below, above = [1] + pre[:-1], suf[1:] + [1]
        out += [q_inv[v] * b % p * a % p for b, a in zip(below, above)]
    return out


def kernel_d(xs, ys, zs, p, threads, group, tree, warp=32, inv=None):
    """Kernel D's schedule on classical ints: (ax, ay) lists, (0, 0) at
    infinity; it asserts that every lane is stored once."""
    inv = inv or (lambda a: pow(a, p - 2, p))
    n = len(zs)
    out_x, out_y = [None] * n, [None] * n
    per_block = threads * group

    def z_of(i):
        if i >= n:
            return 1, 0
        zero = int(zs[i] % p == 0)
        return (1 if zero else zs[i] % p), zero

    def tail(i, zi, zero):
        zi = 0 if zero else zi
        zi2 = zi * zi % p
        assert out_x[i] is None, f"lane {i} stored twice"
        out_x[i] = xs[i] * zi2 % p
        out_y[i] = ys[i] * zi2 % p * zi % p

    for base in range(0, n, per_block):
        lanes = [[base + t + j * threads for j in range(group)] for t in range(threads)]
        prefixes, totals = [], []
        for t in range(threads):
            acc = z_of(lanes[t][0])[0]
            pre = []
            for j in range(1, group):
                pre.append(acc)
                acc = acc * z_of(lanes[t][j])[0] % p
            prefixes.append(pre)
            totals.append(acc)
        if tree:
            assert threads % warp == 0
            invs = block_inverse(totals, p, inv, warp)
        else:
            invs = [inv(v) for v in totals]
        for t in range(threads):
            cur = invs[t]
            for j in range(group - 1, 0, -1):
                i = lanes[t][j]
                zi = cur * prefixes[t][j - 1] % p
                z, zero = z_of(i)
                cur = cur * z % p
                if i < n:
                    tail(i, zi, zero)
            i = lanes[t][0]
            if i < n:
                tail(i, cur, z_of(i)[1])
    assert None not in out_x, "a lane was not stored"
    return out_x, out_y


def _jacobians(curve, n, zero_lanes, seed):
    """(x z^2, y z^3, z) columns of (i+1)G with seeded z, z = 0 at
    ``zero_lanes``."""
    p = curve.p
    zs = [z + 1 for z in rand_ints(np.random.default_rng(seed), p - 1, n)]
    for i in zero_lanes:
        zs[i] = 0
    pts = multiples(curve, n)
    return ([x * z * z % p for (x, _), z in zip(pts, zs)],
            [y * z * z * z % p for (_, y), z in zip(pts, zs)], zs)


def _oracle(cols, curve):
    return [(0, 0) if z == 0 else ocoz.jacobian_to_affine((x, y, z), curve)
            for x, y, z in zip(*cols)]


# (threads, group, warp, tree, lanes, zero lanes): infinity at a group's
# first and last lane (T=4, G=2: thread t's group is {base + t, base + t + 4}),
# two in one group, a whole group, the batch's last lane; ragged batches
SCHEDULES = [
    (4, 2, 4, True, 16, [0, 4, 9, 13, 15]),  # block 0 thread 0, block 1 thread 1: whole groups
    (4, 2, 4, False, 16, [0, 4, 9, 13, 15]),
    (4, 2, 2, True, 13, [3, 7, 8]),  # ragged: the second block's last 3 lanes past the end
    (2, 4, 2, True, 15, [0, 6, 1, 3, 5, 7, 14]),  # thread 1 of block 0 all at infinity
    (2, 4, 2, False, 11, [2, 8]),
    (8, 2, 4, True, 9, [8]),  # one block, most lanes past the end
]


@pytest.mark.parametrize("curve", [TOY64, P256], ids=lambda c: c.name)
@pytest.mark.parametrize("sched", SCHEDULES, ids=lambda s: "T{}G{}w{}{}n{}".format(
    s[0], s[1], s[2], "tree" if s[3] else "", s[4]))
def test_kernel_d_model_matches_oracle_and_plain(curve, sched):
    threads, group, warp, tree, n, zeros = sched
    cols = _jacobians(curve, n, zeros, 120 + n)
    got = kernel_d(*cols, curve.p, threads, group, tree, warp)
    assert list(zip(*got)) == _oracle(cols, curve)
    tc = port_spec(curve)
    d = tc.field.ndigits
    plain = JacobianPoint(*(GFp(tplanes(c, d), tc.field) for c in cols), tc).to_affine()
    assert (ints(plain.x), ints(plain.y)) == got


@pytest.mark.parametrize("curve", [TOY64, P256], ids=lambda c: c.name)
def test_kernel_d_model_matches_jax_to_affine(curve):
    """The model at T = 4, G = 2, a warp of 4, on 16 lanes with infinity at
    a group's first and last lanes and a whole group, against the JAX
    package's JacobianPoint.to_affine (its batch inversion) and the oracle."""
    threads, group, warp, tree, n, zeros = SCHEDULES[0]
    cols = _jacobians(curve, n, zeros, 7)
    got = kernel_d(*cols, curve.p, threads, group, tree, warp)
    d = curve.field.ndigits
    jjac = JJacobian(*(JGFp.from_classical(jnp.asarray(planes(c, d)), curve.field)
                       for c in cols), curve)
    ref = jjac.to_affine()
    assert (ints(ref.x), ints(ref.y)) == got
    assert list(zip(*got)) == _oracle(cols, curve)


def test_kernel_d_model_touches_each_lane_once():
    """Every lane of a ragged batch is stored once (kernel_d asserts it),
    and for each j threads t and t + 1 take lanes i and i + 1."""
    threads, group = 4, 3
    n = 2 * threads * group - 5
    cols = _jacobians(TOY64, n, [], 3)
    kernel_d(*cols, TOY64.p, threads, group, True, 2)
    for base in range(0, n, threads * group):
        for j in range(group):
            row = [base + t + j * threads for t in range(threads)]
            assert row == list(range(row[0], row[0] + threads))


def test_block_inverse_counts():
    """A block of two warps of four shares one inversion, whatever the
    totals."""
    p = TOY64.p
    calls = []

    def inv(a):
        calls.append(a)
        return pow(a, p - 2, p)

    totals = [3, 5, 7, 11, 13, 17, 19, 23]
    got = block_inverse(totals, p, inv, 4)
    assert calls == [math.prod(totals) % p]
    assert got == [pow(t, p - 2, p) for t in totals]


# -- the inversion chains, read from the field headers -----------------------------

INV_FIELDS = {"p256": tspecs.P256.field.p, "secp256k1": tspecs.SECP256K1.field.p,
              "w25519": tspecs.W25519_FIELD.p, "p384": tspecs.P384.field.p,
              "p521": tspecs.P521.field.p}


def chain_source(tag: str) -> str:
    """field_<tag>.cuh's fe_inv body as Python: declarations dropped, the
    one loop (P-521's doublings) as a while loop."""
    text = (CSRC / f"field_{tag}.cuh").read_text()
    m = re.search(r"__device__ __forceinline__ fe fe_inv\(const fe& (\w+)\) \{\n(.*?)\n\}\n",
                  text, re.S)
    arg, body = m.group(1), m.group(2)
    out = [f"{arg} = A"]
    for line in body.splitlines():
        line = line.split("//")[0].strip()
        if not line or line.startswith("#pragma"):
            continue
        loop = re.fullmatch(r"for \(int (\w+) = (\d+); \1 < (\d+); \1 \*= 2\) (.*);", line)
        if loop:
            v, lo, hi, stmt = loop.groups()
            out += [f"{v} = {lo}", f"while {v} < {hi}:", f"    {stmt}", f"    {v} *= 2"]
            continue
        line = re.sub(r"^(const )?fe ", "", line).rstrip(";")
        out.append(re.sub(r"^return ", "RESULT = ", line))
    return "\n".join(out)


@pytest.mark.parametrize("tag", sorted(INV_FIELDS))
def test_inversion_chains_of_the_sources(tag):
    """Each field header's fe_inv, as written, is a^(p - 2) (0 maps to 0),
    and costs what chip_smoke.py's bound charges it (P-256: 255 S + 12 M;
    secp256k1: 255 S + 15 M; 2^255 - 19: 254 S + 11 M; P-384: 385 S + 14
    M; P-521: 524 S + 13 M)."""
    p = INV_FIELDS[tag]
    count = {"M": 0, "S": 0}

    def fe_mul(a, b):
        count["M"] += 1
        return a * b % p

    def fe_sqr(a):
        count["S"] += 1
        return a * a % p

    def fe_sqr_n(a, k):
        for _ in range(k):
            a = fe_sqr(a)
        return a

    code = chain_source(tag)
    for a in (0, 1, 2, p - 1, rand_ints(np.random.default_rng(5), p, 1)[0]):
        count.update(M=0, S=0)
        env = {"fe_mul": fe_mul, "fe_sqr": fe_sqr, "fe_sqr_n": fe_sqr_n, "A": a}
        exec(code, env)
        assert env["RESULT"] == pow(a, p - 2, p)
    want = {"p256": (12, 255), "secp256k1": (15, 255), "w25519": (11, 254),
            "p384": (14, 385), "p521": (13, 524)}[tag]
    assert (count["M"], count["S"]) == want
