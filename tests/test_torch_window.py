"""The port's signed-window scalar multiplication — recoding and
window_plain, the plain version of kernel E, in both strict modes — against
the JAX package's eager twin (kernels/window.window_xla_planes, the same
compute graph as its Pallas kernel) on TOY64, and the strict variant against
the Python-int oracle on P-256, including the adversarial scalars n - 2 and
n - 1. The JAX P-256 twin takes minutes on the CPU and is not run. Curves
with a != -3 (the general-a doubling, Montgomery-form inputs) meet the
port's own oracle with no JAX call: TOYA5, and api.scalar_mult_fast on
secp256k1 and Wei25519. Tolerance: exact."""

import jax.numpy as jnp
import numpy as np
import pytest

from ecsimd_tpu.kernels import window as jwindow
from ecsimd_tpu.oracle import coz as ocoz
from ecsimd_tpu.oracle import window as owindow
from ecsimd_tpu.specs import P256, SECP256K1, WEI25519
from ecsimd_tpu_torch import api
from ecsimd_tpu_torch.field import GFp
from ecsimd_tpu_torch.oracle import coz as tcoz
from ecsimd_tpu_torch.oracle import window as tow
from ecsimd_tpu_torch.kernels import glv as tglv
from ecsimd_tpu_torch.kernels import window as twindow
from tests.toy import TOY64, TOYA5, TOYGLV
from tests.torch_helpers import ints, multiples, planes, port_spec, rand_ints, tplanes

N = 8
TTOY64, TP256, TTOYA5 = port_spec(TOY64), port_spec(P256), port_spec(TOYA5)


def _affine(out, curve):
    """Jacobian planes -> affine int pairs (None at infinity)."""
    p = curve.p
    res = []
    for x, y, z in zip(*(ints(t) for t in out)):
        zi = pow(z, p - 2, p)
        res.append(None if z == 0 else (x * zi * zi % p, y * zi * zi * zi % p))
    return res


def test_recode_matches_oracle():
    rng = np.random.default_rng(90)
    n = P256.order
    ks = [1, 2, 16, 17, n - 2, n - 1] + rand_ints(rng, n, 4)
    idx, neg = twindow.recode(tplanes(ks, 16), TP256)
    assert idx.shape == neg.shape == (64, len(ks))
    for j, k in enumerate(ks):
        digs = owindow.recode(k | 1, 256)[:-1][::-1]  # MSB first, top digit 1 dropped
        got = [(2 * int(i) + 1) * (-1 if int(s) else 1) for i, s in zip(idx[:, j], neg[:, j])]
        assert got == digs


@pytest.mark.parametrize("strict", [False, True], ids=["plain", "strict"])
def test_window_plain_matches_jax_toy64(strict):
    d = TOY64.field.ndigits
    ks = [1, 2, 5, 6, 255, 256] + [k + 1 for k in rand_ints(np.random.default_rng(91),
                                                            TOY64.order - 2, 2)]
    pts = multiples(TOY64, N)
    xs, ys = [x for x, _ in pts], [y for _, y in pts]
    got = twindow.window_plain(tplanes(ks, d), tplanes(xs, d), tplanes(ys, d), TTOY64, strict)
    want = jwindow.window_xla_planes(*(jnp.asarray(planes(v, d)) for v in (ks, xs, ys)), TOY64,
                                     strict=strict)
    for t, j in zip(got, want):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert _affine(got, TOY64) == [
        ocoz.scalar_mult_affine(k, x, y, TOY64) for k, (x, y) in zip(ks, pts)]


def test_window_p256_vs_oracle():
    """Strict, distinct points (i+1)G: n - 2 (a degenerate add of the plain
    window) and n - 1 (the accumulator reaches infinity): (n-1)P = -P,
    (n-2)P = -2P. The plain window's P-256 formulas (jac_add, add_z2_1) run
    inside this one's complete add and in the ladder's tests."""
    n, p = P256.order, P256.p
    rng = np.random.default_rng(92)
    ks = [n - 2, n - 1, 2] + [k + 1 for k in rand_ints(rng, n - 2, 1)]
    pts = multiples(P256, len(ks))
    out = twindow.scalar_mult(api.scalars_from_ints(ks, TP256, device="cpu"),
                              api.points_from_ints(*zip(*pts), TP256, device="cpu"), True)
    want = [(x, (p - y) % p) if k == n - 1 else ocoz.scalar_mult_affine(k, x, y, P256)
            for k, (x, y) in zip(ks, pts)]
    assert _affine((out.x.planes, out.y.planes, out.z.planes), P256) == want


def test_api_fast_paths_toy64():
    """api.scalar_mult_fast (both modes) and scalar_mult_shared_fast end in
    the affine conversion; CPU tensors launch no kernel."""
    ks = [3, 4, 1000, 77]
    pts = multiples(TOY64, len(ks))
    pt = api.points_from_ints(*zip(*pts), TTOY64, device="cpu")
    s = api.scalars_from_ints(ks, TTOY64, device="cpu")
    before = (twindow.KERNEL.launches, twindow.KERNEL_STRICT.launches)
    want = [ocoz.scalar_mult_affine(k, x, y, TOY64) for k, (x, y) in zip(ks, pts)]
    for strict in (False, True):
        out = api.scalar_mult_fast(s, pt, strict=strict)
        assert list(zip(ints(out.x), ints(out.y))) == want
    out = api.scalar_mult_shared_fast(12345, pt)
    assert list(zip(ints(out.x), ints(out.y))) == [
        ocoz.scalar_mult_affine(12345, x, y, TOY64) for x, y in pts]
    assert (twindow.KERNEL.launches, twindow.KERNEL_STRICT.launches) == before


def test_strict_varbase_routes_to_the_strict_window():
    ks = [6, 7]
    pts = multiples(TOY64, 2)
    pt = api.points_from_ints(*zip(*pts), TTOY64, device="cpu")
    got = tglv.strict_varbase(api.scalars_from_ints(ks, TTOY64, device="cpu"), pt)
    want = twindow.scalar_mult(api.scalars_from_ints(ks, TTOY64, device="cpu"), pt, strict=True)
    for a, b in zip((got.x, got.y, got.z), (want.x, want.y, want.z)):
        assert ints(a.planes) == ints(b.planes)
    # GLV curves go to the strict GLV chain (tests/test_torch_glv.py)
    glv = port_spec(TOYGLV)
    s3 = api.scalars_from_ints([3], glv, device="cpu")
    g = api.generator_batch(glv, 1, device="cpu")
    got = tglv.strict_varbase(s3, g)
    want = tglv.scalar_mult(s3, g, strict=True)
    assert ints(got.x.planes) == ints(want.x.planes) and ints(got.z.planes) == ints(want.z.planes)


@pytest.mark.parametrize("strict", [False, True], ids=["plain", "strict"])
def test_kernel_entry_takes_cuda_tensors_only(strict):
    g = api.generator_batch(TP256, 1, device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        twindow.window_planes(api.scalars_from_ints([3], TP256, device="cpu"), g.x, g.y,
                              strict=strict)


@pytest.mark.parametrize("strict", [False, True], ids=["plain", "strict"])
def test_window_plain_general_a_toya5(strict):
    """window_plain on an a != -3 curve over a Montgomery field: the
    general-a doubling (group.dbl_any) on Montgomery-form planes, against
    the port's oracle window (oracle/window.scalar_mult, generic in a).
    The plain chain's table and doublings give the oracle's Jacobian
    representative; the strict chain's complete adds another one, so it is
    compared in affine form."""
    fs = TTOYA5.field
    p, d = fs.p, fs.ndigits
    ks = [1, 2] + [k + 1 for k in rand_ints(np.random.default_rng(93), TOYA5.order - 2, 4)] + [
        TOYA5.order - 1]
    pts = multiples(TOYA5, len(ks))
    xs, ys = [x for x, _ in pts], [y for _, y in pts]
    xm, ym = (GFp.from_classical(tplanes(v, d), fs).planes for v in (xs, ys))
    got = twindow.window_plain(tplanes(ks, d), xm, ym, TTOYA5, strict)
    r_inv = pow(fs.R, -1, p)
    jac = list(zip(*([v * r_inv % p for v in ints(t)] for t in got)))
    want = [tow.scalar_mult(k, (x, y, 1), TTOYA5) for k, (x, y) in zip(ks, pts)]
    if not strict:
        assert jac == want
    assert [tcoz.jacobian_to_affine(j, TTOYA5) for j in jac] == [
        tcoz.jacobian_to_affine(w, TTOYA5) for w in want]


@pytest.mark.parametrize("curve", [SECP256K1, WEI25519], ids=["secp256k1", "wei25519"])
def test_api_scalar_mult_fast_general_a(curve):
    """api.scalar_mult_fast on CPU tensors of the two a != -3 curves with a
    kernel-backed comb (secp256k1: a = 0, Montgomery field; Wei25519:
    general a, Crandall field), against the oracle's k * P."""
    tc = port_spec(curve)
    ks = [2, 3 + rand_ints(np.random.default_rng(94), curve.order - 4, 1)[0]]
    pts = multiples(curve, len(ks))
    out = api.scalar_mult_fast(api.scalars_from_ints(ks, tc, device="cpu"),
                               api.points_from_ints(*zip(*pts), tc, device="cpu"))
    assert list(zip(ints(out.x), ints(out.y))) == [
        tcoz.scalar_mult_affine(k, x, y, tc) for k, (x, y) in zip(ks, pts)]
