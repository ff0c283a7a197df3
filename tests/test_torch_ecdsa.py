"""The port's batched ECDSA (ecsimd_tpu_torch/ecdsa.py: sign_planes,
verify_planes, recover_planes, RFC 6979, the int interfaces) against the JAX
package's (ecsimd_tpu/ecdsa.py, interpret mode: its comb kernel and the GLV
and window kernels' eager twins) and the Python-int ECDSA oracle
(ecsimd_tpu/oracle/ecdsa.py).

JAX is compared on the 2-digit toy GLV curve TOYGLV (Montgomery field, GLV
routing): sign, verify (strict and the fast path) and recover; and on the
4-digit TOY64E (Solinas field, comb and window routing) for the strict
verify. Each JAX call runs its kernels' eager twins or a Pallas kernel in
interpret mode, 6-25 s apiece on the CPU (op-by-op dispatch), so TOY64E's
sign and recovery (kernels held to the JAX package in
tests/test_torch_comb.py and test_torch_window.py) and P-256 and secp256k1
sign are held to the oracle; 256-bit verification and recovery, ~20 s a
call in plain PyTorch on the CPU, run against the oracle on the card
(tests/test_torch_cuda.py, chip_smoke.py phase 12). Tolerance: exact (r, s
planes and masks identical).

One documented difference: with allow_fast_paths=True on a GLV curve the JAX
package verifies u2 Q, whose u2 = r / s the signer chooses, with the plain
GLV chain (outside its domain of trusted uniform scalars); the port keeps
the strict chain there. ``test_verify_fast_path_u2_lambda_deviation`` pins
the port to the oracle on lanes with u2 in {lambda, lambda +- 1} (k1 = 0 or
+-1) and records the JAX package's verdicts there: they equal the oracle's,
since the force-odd recoding turns k1 = 0 into 1 and the parity fix-up
takes it back off without a collision.
"""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecsimd_tpu import ecdsa as jecdsa
from ecsimd_tpu import glv as jglv
from ecsimd_tpu.oracle import ecdsa as oecdsa
from ecsimd_tpu.specs import P256, SECP256K1
from ecsimd_tpu_torch import ecdsa as tecdsa
from tests.test_rfc6979 import UX_A25, UY_A25, VECTORS, X_A25
from tests.toy import TOY64, TOY64E, TOYGLV
from tests.torch_helpers import ints, planes, port_spec, rand_ints, tplanes

LANES = 8


def _batch(curve, seed, lanes=LANES):
    """Keys, nonces and hashes, lane 0 with hash 0 (u1 == 0 in verify)."""
    rng = np.random.default_rng(seed)
    n = curve.order
    ds = [k + 1 for k in rand_ints(rng, n - 1, lanes)]
    ks = [k + 1 for k in rand_ints(rng, n - 1, lanes)]
    zs = rand_ints(rng, 1 << curve.field.nbits, lanes)
    zs[0] = 0
    return ds, ks, zs


def _jax(vals, curve):
    return jnp.asarray(planes(vals, curve.field.ndigits))


def _t(vals, curve):
    return tplanes(vals, curve.field.ndigits)


def test_sign_matches_jax_and_oracle():
    """TOYGLV: r, s and the mask against the JAX sign_planes, with a zero
    nonce and an out-of-range key in the batch; valid lanes against the
    oracle."""
    curve = TOYGLV
    ds, ks, zs = _batch(curve, 130)
    ks[6] = 0
    ds[7] = curve.order
    r, s, ok = tecdsa.sign_planes(_t(zs, curve), _t(ds, curve), _t(ks, curve), port_spec(curve))
    jr, js, jok = jecdsa.sign_planes(_jax(zs, curve), _jax(ds, curve), _jax(ks, curve), curve,
                                     tile=LANES, interpret=True)
    for got, want in ((r, jr), (s, js), (ok, jok)):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert ok.tolist() == [1] * 6 + [0, 0]
    assert list(zip(ints(r), ints(s)))[:6] == [
        oecdsa.sign(z, d, k, curve) for z, d, k in zip(zs[:6], ds[:6], ks[:6])]


@pytest.mark.parametrize("curve", [TOY64E, P256, SECP256K1], ids=lambda c: c.name)
def test_sign_vs_oracle(curve):
    """4 lanes on the CPU: two honest ones give the oracle's (r, s), which
    the oracle verifies; a zero nonce and an out-of-range key are masked."""
    ds, ks, zs = _batch(curve, 136, 4)
    ks[2] = 0
    ds[3] = curve.order
    r, s, ok = tecdsa.sign_planes(_t(zs, curve), _t(ds, curve), _t(ks, curve), port_spec(curve))
    assert ok.tolist() == [1, 1, 0, 0]
    sigs = list(zip(ints(r), ints(s)))[:2]
    assert sigs == [oecdsa.sign(z, d, k, curve) for z, d, k in zip(zs, ds, ks[:2])]
    assert all(oecdsa.verify(z, r_, s_, *oecdsa.keypair(d, curve), curve)
               for z, (r_, s_), d in zip(zs, sigs, ds))


def _tampered(curve, seed):
    """Honest signatures on lanes 0..3 (lane 0: hash 0), then r + 1, s = 0,
    s = n and an off-curve Q; the oracle's verdicts."""
    n, p = curve.order, curve.p
    ds, ks, zs = _batch(curve, seed)
    sigs = [oecdsa.sign(z, d, k, curve) for z, d, k in zip(zs, ds, ks)]
    rs, ss = [sg[0] for sg in sigs], [sg[1] for sg in sigs]
    qs = [oecdsa.keypair(d, curve) for d in ds]
    qxs, qys = [q[0] for q in qs], [q[1] for q in qs]
    rs[4] = (rs[4] + 1) % n
    ss[5] = 0
    ss[6] = n
    qys[7] = (qys[7] + 1) % p
    want = [int(oecdsa.verify(*v, curve)) for v in zip(zs, rs, ss, qxs, qys)]
    assert want == [1] * 4 + [0] * 4
    return zs, rs, ss, qxs, qys, want


def test_verify_toy64e_vs_oracle():
    """Verification on TOY64E (the strict window; the fast path: comb and
    plain window): masks equal the oracle's on the tampered batch, and the
    strict mask the JAX verify_planes' (strict, interpret mode)."""
    curve = TOY64E
    vals = _tampered(curve, 131)
    want = vals[-1]
    planes_ = [_t(v, curve) for v in vals[:-1]]
    got = tecdsa.verify_planes(*planes_, port_spec(curve))
    jgot = jecdsa.verify_planes(*(_jax(v, curve) for v in vals[:-1]), curve, tile=LANES,
                                interpret=True)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jgot))
    assert got.tolist() == want
    assert tecdsa.verify_planes(*planes_, port_spec(curve), allow_fast_paths=True).tolist() == want


def _u2_lane(curve, u2, seed):
    """A valid signature with u2 = r / s mod n = ``u2``: pick d, k, then
    s = r / u2 and the hash e = s (k - u2 d)."""
    n = curve.order
    d, k = (v + 1 for v in rand_ints(np.random.default_rng(seed), n - 1, 2))
    r = oecdsa.keypair(k, curve)[0] % n
    s = r * pow(u2, -1, n) % n
    z = s * (k - u2 * d) % n
    q = oecdsa.keypair(d, curve)
    assert oecdsa.verify(z, r, s, *q, curve) and r * pow(s, -1, n) % n == u2
    return z, r, s, q


def test_verify_fast_path_u2_lambda_deviation():
    """TOYGLV, allow_fast_paths=True: the tampered batch with lanes 1..3
    replaced by valid signatures with u2 = lambda, lambda - 1, lambda + 1.
    The port (strict GLV for u2 Q in every mode) equals the oracle on every
    lane, strict and fast; its strict mask equals the JAX package's strict
    verify_planes on every lane, its fast mask the JAX fast path on the other
    lanes. On lanes 1..3 the JAX package's plain chain runs outside its
    domain; its verdicts there are recorded: they equal the oracle's."""
    curve, tc = TOYGLV, port_spec(TOYGLV)
    zs, rs, ss, qxs, qys, want = _tampered(curve, 132)
    lam = jglv.glv_params(curve).lam
    for i, u2 in enumerate((lam, lam - 1, lam + 1)):
        z, r, s, q = _u2_lane(curve, u2, 133 + i)
        for vals, v in zip((zs, rs, ss, qxs, qys), (z, r, s, q[0], q[1])):
            vals[1 + i] = v
    vals = (zs, rs, ss, qxs, qys)
    fast = tecdsa.verify_planes(*(_t(v, curve) for v in vals), tc, allow_fast_paths=True)
    strict = tecdsa.verify_planes(*(_t(v, curve) for v in vals), tc)
    jfast, jstrict = (np.asarray(jecdsa.verify_planes(
        *(_jax(v, curve) for v in vals), curve, tile=LANES, interpret=True,
        allow_fast_paths=fast_paths)) for fast_paths in (True, False))
    assert fast.tolist() == strict.tolist() == want
    np.testing.assert_array_equal(strict.numpy(), jstrict)
    others = [0, 4, 5, 6, 7]
    np.testing.assert_array_equal(fast.numpy()[others], jfast[others])
    assert jfast[1:4].tolist() == [1, 1, 1]  # recorded: the JAX plain chain gets these right


def _recoverable(curve, seed, lanes=LANES):
    ds, ks, zs = _batch(curve, seed, lanes)
    out = [oecdsa.sign_recoverable(z, d, k, curve) for z, d, k in zip(zs, ds, ks)]
    qs = [oecdsa.keypair(d, curve) for d in ds]
    return zs, [o[0] for o in out], [o[1] for o in out], [o[2] for o in out], qs


def test_recover_matches_jax_toyglv():
    """Recovery on TOYGLV against the JAX recover_planes: lane 3 with an
    overflow id (r + n >= p here), lane 4 with the wrong parity, lane 5 with
    s = 0, the others honest."""
    curve = TOYGLV
    zs, rs, ss, vs, qs = _recoverable(curve, 134)
    vs[3] |= 2
    vs[4] ^= 1
    ss[5] = 0
    v = torch.tensor(vs, dtype=torch.int32)
    qx, qy, ok = tecdsa.recover_planes(_t(zs, curve), _t(rs, curve), _t(ss, curve), v,
                                       port_spec(curve))
    jqx, jqy, jok = jecdsa.recover_planes(_jax(zs, curve), _jax(rs, curve), _jax(ss, curve),
                                          jnp.asarray(np.asarray(vs, np.int32)), curve,
                                          tile=LANES, interpret=True)
    for got, want in ((qx, jqx), (qy, jqy), (ok, jok)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want = [oecdsa.recover(*a, curve) for a in zip(zs, rs, ss, vs)]
    assert [bool(o) for o in ok.tolist()] == [w is not None for w in want]
    assert [(x, y) for x, y, o in zip(ints(qx), ints(qy), ok.tolist()) if o] == [
        w for w in want if w]
    assert want[:3] == qs[:3] and want[4] != qs[4] and want[5] is None


def test_recover_toy64e_vs_oracle():
    """Recovery on TOY64E (Tonelli-Shanks square root, 2-adicity 32)."""
    curve = TOY64E
    zs, rs, ss, vs, qs = _recoverable(curve, 135, 4)
    vs[3] ^= 1
    got = tecdsa.recover_ints(zs, rs, ss, vs, port_spec(curve), device="cpu")
    want = [oecdsa.recover(*a, curve) for a in zip(zs, rs, ss, vs)]
    assert got == want and want[:3] == qs[:3]


def test_rfc6979_vectors():
    """RFC 6979 A.2.5 (P-256, SHA-256): nonces equal the RFC's and the JAX
    package's, and sign_hashes reproduces the RFC's (r, s), which verify."""
    tc = port_spec(P256)
    h1s = [hashlib.sha256(msg).digest() for msg, _, _, _ in VECTORS]
    for h1, (_, k, _, _) in zip(h1s, VECTORS):
        assert tecdsa.rfc6979_nonce(h1, X_A25, tc) == k == jecdsa.rfc6979_nonce(h1, X_A25, P256)
    rs, ss = tecdsa.sign_hashes(h1s, [X_A25] * len(h1s), tc, device="cpu")
    assert list(zip(rs, ss)) == [(r, s) for _, _, r, s in VECTORS]
    zs = [tecdsa._bits2int(h, 256) for h in h1s]
    assert zs == [jecdsa._bits2int(h, 256) for h in h1s]
    assert all(oecdsa.verify(z, r, s, UX_A25, UY_A25, P256) for z, r, s in zip(zs, rs, ss))


def test_order_field_and_helpers():
    """order_field equals the JAX package's spec; a placeholder order is
    refused; _mod_n reduces [n, 2^nbits) by one subtraction."""
    for curve in (P256, SECP256K1, TOYGLV):
        t, j = tecdsa.order_field(port_spec(curve)), jecdsa.order_field(curve)
        assert t.name == j.name and (t.p, t.nbits, t.reduction) == (j.p, j.nbits, j.reduction)
        assert tecdsa.curve_order_big_enough(t) == jecdsa.curve_order_big_enough(j)
    with pytest.raises(AssertionError, match="placeholder"):
        tecdsa.order_field(port_spec(TOY64))
    n = SECP256K1.order
    vals = [0, 1, n - 1, n, n + 5, (1 << 256) - 1]
    fs_n = tecdsa.order_field(port_spec(SECP256K1))
    assert ints(tecdsa._mod_n(tplanes(vals, 16).to(torch.int64), fs_n)) == [v % n for v in vals]
