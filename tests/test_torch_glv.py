"""The port's GLV split and chain (ecsimd_tpu_torch/glv.py, kernels/glv.py:
glv_params, split_planes, pack_scalars, glv_plain — the plain version of
kernel F — strict_varbase, api.scalar_mult_glv) against the JAX package's
(ecsimd_tpu/glv.py, kernels/glv.py: glv_xla_planes, the GLV kernel's eager
twin) and the Python-int oracle, on the 2-digit toy GLV curve TOYGLV and
on secp256k1 (host split only: the JAX package's d = 16 twin takes minutes
to compile on the CPU). Tolerance: exact. The lambda-class scalars (k1 = 0,
mid-chain collisions) ride in every batch."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecsimd_tpu import ecdh as jecdh
from ecsimd_tpu import glv as jglv
from ecsimd_tpu.field import GFp as JGFp
from ecsimd_tpu.kernels import glv as jkglv
from ecsimd_tpu.oracle import coz as ocoz
from ecsimd_tpu.specs import SECP256K1
from ecsimd_tpu_torch import api, ecdh as tecdh
from ecsimd_tpu_torch import glv as tglv
from ecsimd_tpu_torch.field import GFp
from ecsimd_tpu_torch.kernels import glv as tkglv
from ecsimd_tpu_torch.kernels import window as twindow
from tests.toy import TOYGLV
from tests.torch_helpers import ints, multiples, planes, port_spec, rand_ints, tplanes

TTOYGLV, TK1 = port_spec(TOYGLV), port_spec(SECP256K1)


def _lambda_class(curve, n_random, seed):
    pp = jglv.glv_params(curve)
    n = curve.order
    edges = [1, 2, pp.lam, pp.lam - 1, pp.lam + 1, n - 1, n - 2, (n - 1) // 2]
    return edges + [k + 1 for k in rand_ints(np.random.default_rng(seed), n - 1, n_random)]


@pytest.mark.parametrize("curve", [TOYGLV, SECP256K1], ids=lambda c: c.name)
def test_glv_params_equal_the_reference(curve):
    t, j = tglv.glv_params(port_spec(curve)), jglv.glv_params(curve)
    assert type(t) is tglv.GLVParams and dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.max_half_bits == j.max_half_bits
    assert tglv._cube_roots(curve.p) == jglv._cube_roots(curve.p)
    assert tglv._barrett_shift(curve.field.nbits) == jglv._barrett_shift(curve.field.nbits)
    k = _lambda_class(curve, 4, 120)
    assert [tglv.split_int(v, t, curve.order) for v in k] == [
        jglv.split_int(v, j, curve.order) for v in k]


def test_split_planes_matches_jax_on_toyglv():
    """split_planes and pack_scalars against the JAX pack_scalars, whose rows
    are the JAX split_planes' k1, k2, sign of k1, sign of k2."""
    ks = _lambda_class(TOYGLV, 8, 121)
    dk = jglv.glv_params(TOYGLV).dk
    want = np.asarray(jkglv.pack_scalars(jnp.asarray(planes(ks, 2)), TOYGLV))
    k1, k2, n1, n2 = tglv.split_planes(tplanes(ks, 2), TTOYGLV)
    for g, w in ((k1, want[:dk]), (k2, want[dk:2 * dk]), (n1, want[2 * dk]),
                 (n2, want[2 * dk + 1])):
        np.testing.assert_array_equal(g.numpy(), w)
    np.testing.assert_array_equal(tkglv.pack_scalars(tplanes(ks, 2), TTOYGLV).numpy(), want)


def test_split_planes_matches_split_int_on_secp256k1():
    ks = _lambda_class(SECP256K1, 8, 122)
    pp, n = jglv.glv_params(SECP256K1), SECP256K1.order
    k1, k2, n1, n2 = tglv.split_planes(tplanes(ks, 16), TK1)
    assert k1.shape == (pp.dk, len(ks)) == (9, len(ks))
    for k, a, b, s1, s2 in zip(ks, ints(k1), ints(k2), n1.tolist(), n2.tolist()):
        assert (a, bool(s1), b, bool(s2)) == jglv.split_int(k, pp, n)
        assert ((-a if s1 else a) + (-b if s2 else b) * pp.lam) % n == k % n


@pytest.mark.parametrize("strict", [True, False], ids=["strict", "plain"])
def test_glv_plain_matches_jax_twin(strict):
    """glv_plain against glv_xla_planes on TOYGLV: Montgomery-form Jacobian
    planes identical, lambda-class scalars included; strict also against
    the oracle (the plain chain is held to the twin only: it shares its
    wrong values on the degenerate lanes by design)."""
    ks = _lambda_class(TOYGLV, 0, 123)  # the 8 lambda-class lanes
    pts = multiples(TOYGLV, len(ks))
    fs = TOYGLV.field
    jx = JGFp.from_classical(jnp.asarray(planes([x for x, _ in pts], 2)), fs).planes
    jy = JGFp.from_classical(jnp.asarray(planes([y for _, y in pts], 2)), fs).planes
    packed = jkglv.pack_scalars(jnp.asarray(planes(ks, 2)), TOYGLV)
    want = jkglv.glv_xla_planes(packed, jx, jy, TOYGLV, strict=strict)
    got = tkglv.glv_plain(torch.tensor(np.asarray(packed)), torch.tensor(np.asarray(jx)),
                          torch.tensor(np.asarray(jy)), TTOYGLV, strict)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if strict:
        out = api.scalar_mult_glv(tplanes(ks, 2), api.points_from_ints(
            [x for x, _ in pts], [y for _, y in pts], TTOYGLV, device="cpu"))
        n = TOYGLV.order
        want_aff = [ocoz.scalar_mult_affine(k * (i + 1) % n, TOYGLV.gx, TOYGLV.gy, TOYGLV)
                    if (k * (i + 1) + 1) % n > 1 else None for i, k in enumerate(ks)]
        got_aff = list(zip(ints(out.x), ints(out.y)))
        assert [g for g, w in zip(got_aff, want_aff) if w] == [w for w in want_aff if w]


def test_strict_varbase_routes_glv_curves_to_glv():
    ks = _lambda_class(TOYGLV, 2, 124)
    pts = multiples(TOYGLV, len(ks))
    pt = api.points_from_ints([x for x, _ in pts], [y for _, y in pts], TTOYGLV, device="cpu")
    s = tplanes(ks, 2)
    launches = (tkglv.KERNEL_STRICT.launches, twindow.KERNEL_STRICT.launches)
    got = tkglv.strict_varbase(s, pt)
    want = tkglv.scalar_mult(s, pt, strict=True)
    for a, b in zip((got.x, got.y, got.z), (want.x, want.y, want.z)):
        assert torch.equal(a.planes, b.planes)
    assert (tkglv.KERNEL_STRICT.launches, twindow.KERNEL_STRICT.launches) == launches


def test_ecdh_toyglv_vs_oracle():
    """ECDH on TOYGLV: the shared secret through strict_varbase -> the GLV
    chain (held to the JAX twin by test_glv_plain_matches_jax_twin), with a
    lambda scalar, a zero scalar and an off-curve peer. The mask equals the
    JAX package's own validation (_scalar_ok & validate_public), the secrets
    the oracle's."""
    curve, d, n, p = TOYGLV, 2, TOYGLV.order, TOYGLV.p
    rng = np.random.default_rng(125)
    ds = [k + 1 for k in rand_ints(rng, n - 1, 8)]
    ds[2] = jglv.glv_params(curve).lam
    qs = [ocoz.scalar_mult_affine(k + 2, curve.gx, curve.gy, curve) for k in range(8)]
    qxs, qys = [q[0] for q in qs], [q[1] for q in qs]
    ds[6] = 0
    qys[7] = (qys[7] + 1) % p
    sx, ok = tecdh.shared_secret_planes(*(tplanes(v, d) for v in (ds, qxs, qys)), TTOYGLV)
    jds, jqx, jqy = (jnp.asarray(planes(v, d)) for v in (ds, qxs, qys))
    jok = jecdh._scalar_ok(jds, curve) & jecdh.validate_public(jqx, jqy, curve)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    assert ok.tolist() == [1] * 6 + [0, 0]
    assert ints(sx)[:6] == [ocoz.scalar_mult_affine(k * (i + 2) % n, curve.gx, curve.gy, curve)[0]
                            for i, k in enumerate(ds[:6])]


def test_glv_kernel_entry_takes_cuda_tensors_only():
    s = tplanes([5], 16)
    packed = tkglv.pack_scalars(s, TK1)
    g = api.generator_batch(TK1, 1, device="cpu")
    xm = GFp.from_classical(g.x, TK1.field).planes
    with pytest.raises(ValueError, match="CUDA"):
        tkglv.glv_planes(packed, xm, xm, TK1)
