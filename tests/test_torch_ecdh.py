"""The port's batched ECDH (ecsimd_tpu_torch.ecdh) against the JAX package's
(ecsimd_tpu/ecdh.py: its scalar range check, and shared_secret_planes with
interpret-mode kernels, the strict window's eager twin) on the exact-order
toy curve TOY64E, with the adversarial lanes of tests/test_ecdh.py (zero
scalar, scalar = n, off-curve peer, x = p), and on P-256 against the
Python-int oracle. The JAX derive_public_planes is the comb kernel and the
same range check; its comb is held to the port's in test_torch_comb.py, so
the port's derive is held to the oracle here. Tolerance: exact (masks
identical; x identical on valid lanes)."""

import jax.numpy as jnp
import numpy as np
import pytest

from ecsimd_tpu import ecdh as jecdh
from ecsimd_tpu.oracle import coz as ocoz
from ecsimd_tpu.specs import P256
from ecsimd_tpu_torch import ecdh as tecdh
from ecsimd_tpu_torch.kernels import comb, window
from tests.toy import TOY64E
from tests.torch_helpers import ints, planes, port_spec, rand_ints, tplanes

LANES = 16
TTOY64E, TP256 = port_spec(TOY64E), port_spec(P256)


def test_ecdh_toy64e_matches_jax_with_invalid_lanes():
    curve, d = TOY64E, TOY64E.field.ndigits
    rng = np.random.default_rng(100)
    ds = [k + 1 for k in rand_ints(rng, (1 << 62) - 1, LANES)]
    es = [k + 1 for k in rand_ints(rng, (1 << 62) - 1, LANES)]
    launches = (comb.KERNEL.launches, window.KERNEL_STRICT.launches)

    qx, qy, okq = tecdh.derive_public_planes(tplanes(es, d), TTOY64E)
    want_q = [ocoz.scalar_mult_affine(e, curve.gx, curve.gy, curve) for e in es]
    assert list(zip(ints(qx), ints(qy))) == want_q and okq.tolist() == [1] * LANES

    qxs, qys = [q[0] for q in want_q], [q[1] for q in want_q]
    ds[12] = 0  # zero scalar
    ds[13] = curve.order  # out of range
    qys[14] = (qys[14] + 1) % curve.p  # off-curve peer
    qxs[15] = curve.p  # non-canonical coordinate
    np.testing.assert_array_equal(tecdh._scalar_ok(tplanes(ds, d), TTOY64E).numpy(),
                                  np.asarray(jecdh._scalar_ok(jnp.asarray(planes(ds, d)), curve)))
    sx, ok = tecdh.shared_secret_planes(*(tplanes(v, d) for v in (ds, qxs, qys)), TTOY64E)
    jsx, jok = jecdh.shared_secret_planes(*(jnp.asarray(planes(v, d)) for v in (ds, qxs, qys)),
                                          curve, tile=LANES, interpret=True)
    assert ok.numpy().dtype == np.asarray(jok).dtype == np.int32
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    assert ok.tolist() == [1] * 12 + [0] * 4
    np.testing.assert_array_equal(sx.numpy()[:, :12], np.asarray(jsx)[:, :12])
    assert ints(sx)[:12] == [
        ocoz.scalar_mult_affine(k, x, y, curve)[0] for k, x, y in zip(ds[:12], qxs, qys)]
    assert (comb.KERNEL.launches, window.KERNEL_STRICT.launches) == launches


def test_ecdh_p256_both_parties_agree_with_oracle():
    """Two lanes per party: Q1 = d1 G, Q2 = d2 G in one batch, then d1 Q2
    and d2 Q1 in one batch; both give the oracle's shared x."""
    n = P256.order
    rng = np.random.default_rng(101)
    d1 = [k + 1 for k in rand_ints(rng, n - 2, 2)]
    d2 = [n - 2] + [k + 1 for k in rand_ints(rng, n - 2, 1)]  # n - 2: strict window's case
    qx, qy = tecdh.derive_public_ints(d1 + d2, TP256, device="cpu")
    assert list(zip(qx, qy)) == [ocoz.scalar_mult_affine(k, P256.gx, P256.gy, P256)
                                 for k in d1 + d2]
    sx, ok = tecdh.shared_secret_ints(d1 + d2, qx[2:] + qx[:2], qy[2:] + qy[:2], TP256,
                                      device="cpu")
    want = [ocoz.scalar_mult_affine(a * b % n, P256.gx, P256.gy, P256)[0]
            for a, b in zip(d1, d2)]
    assert ok == [True] * 4 and sx == want + want


def test_ecdh_ints_reject_invalid_keys():
    curve = TTOY64E
    with pytest.raises(ValueError, match="out of"):
        tecdh.derive_public_ints([0, 5], curve, device="cpu")
    q = ocoz.scalar_mult_affine(7, curve.gx, curve.gy, curve)
    sx, ok = tecdh.shared_secret_ints([3, curve.order, 3], [q[0]] * 3,
                                      [q[1], q[1], (q[1] + 1) % curve.p], curve, device="cpu")
    assert ok == [True, False, False]
    assert sx == [ocoz.scalar_mult_affine(21, curve.gx, curve.gy, curve)[0], None, None]
