"""The port's X25519 path — the x-only ladder's plain version
(kernels/mladder.mladder_plain), the x / z epilogue, x25519.py and the
Wei25519 comb keygen — against the JAX package's Pallas ladder in interpret
mode on the toy field CRAN64, the host int ladder of tests/test_mladder.py,
the RFC 7748 §5.2 vectors and the `cryptography` package. The JAX X25519
path itself is not called (its XLA ladder compiles for ~100 s).
Tolerance: exact."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from cryptography.hazmat.primitives.asymmetric.x25519 import X25519PrivateKey, X25519PublicKey

from ecsimd_tpu.kernels import comb as jcomb
from ecsimd_tpu.kernels import mladder as jmladder
from ecsimd_tpu.specs import W25519_FIELD, WEI25519
from ecsimd_tpu_torch import x25519
from ecsimd_tpu_torch.kernels import comb as tcomb
from ecsimd_tpu_torch.kernels import mladder
from tests.test_mladder import host_xladder
from tests.toy import CRAN64
from tests.torch_helpers import ints, planes, port_spec, rand_ints, tplanes

P = W25519_FIELD.p
V1_K = bytes.fromhex("a546e36bf0527c9d3b16154b82465edd62144c0ac1fc5a18506a2244ba449ac4")
V1_U = bytes.fromhex("e6db6867583030db3594c1a424b15f7c726624ec26b3353b10a903a6d0ab1c4c")
V1_OUT = "c3da55379de9c6908e94ea4df28d084f32eccf03491c71f754b4075577a28552"
V2_K = bytes.fromhex("4b66e9d4d1b4673c5ad22691957d6af5c11b6421e0ea01d42ca4169e7918ba0d")
V2_U = bytes.fromhex("e5210f12786811d3f4b7959d0538ae2c31dbe7106fc03c3efc4cd549c715a493")
V2_OUT = "95cbde9476e8907d7aade45cb4b873f88b595a68799fa152e6f8f7647aac7957"
BASE = (9).to_bytes(32, "little")
ITER1 = "422c8e7a6227d7bca1350b3e2bb7279f7897b87bb6854b783c60e80311ae3079"


def _le(v: int) -> bytes:
    return v.to_bytes(32, "little")


def _masked_top(u: bytes) -> bytes:
    b = bytearray(u)
    b[31] |= 0x80
    return bytes(b)


# lane name -> (k, u, expected output): the RFC 7748 §5.2 vectors and
# iteration 1, u = 0 (low order: output 0), u with the top bit set (masked),
# and u in [p, 2^255) (reduced once before the ladder)
RFC_LANES = {
    "vector1": (V1_K, V1_U, V1_OUT),
    "vector2": (V2_K, V2_U, V2_OUT),
    "iteration1": (BASE, BASE, ITER1),
    "u0": (V1_K, _le(0), "00" * 32),
    "masked_top_bit": (V1_K, _masked_top(V1_U), V1_OUT),
    "u_p": (V2_K, _le(P), "00" * 32),  # p = 0 mod p
    "u_p_plus_1": (V2_K, _le(P + 1), "00" * 32),  # = 1, low order
    "u_2p255_minus_1": (V1_K, _le((1 << 255) - 1), None),
}


@functools.cache
def _rfc_batch():
    """Every RFC lane through one CPU call of the port's x25519_batch."""
    ks, us, _ = zip(*RFC_LANES.values())
    return dict(zip(RFC_LANES, x25519.x25519_batch(list(ks), list(us), device="cpu")))


@pytest.mark.parametrize("lane", list(RFC_LANES))
def test_x25519_batch_rfc7748(lane):
    k, u, want = RFC_LANES[lane]
    got = _rfc_batch()[lane]
    x2, z2 = host_xladder(x25519.clamp(k), x25519.decode_u(u) % P, P, x25519.A24, 255)
    assert got == _le(x2 * pow(z2, P - 2, P) % P)
    if want is None:  # cryptography refuses the all-zero results, so only here
        want = X25519PrivateKey.from_private_bytes(k).exchange(
            X25519PublicKey.from_public_bytes(u)).hex()
    assert got.hex() == want


def test_mladder_plain_matches_jax_interpret_and_host_ladder_cran64():
    """One interpret-mode call of the JAX Pallas ladder on CRAN64 (8 lanes,
    a24 = 5, 61 bits; any a24 is plain algebra), projective planes equal."""
    fs, a24, nbits = CRAN64, 5, 61
    rng = np.random.default_rng(60)
    ks = rand_ints(rng, 1 << nbits, 8, edges=[0, 1, (1 << nbits) - 1])
    us = rand_ints(rng, fs.p, 8, edges=[0, 1, fs.p - 1])
    kp, up = planes(ks, fs.ndigits), planes(us, fs.ndigits)
    jx, jz = jmladder.mladder_planes(jnp.asarray(kp), jnp.asarray(up), fs, a24, nbits, tile=8,
                                     interpret=True)
    tx, tz = mladder.mladder_plain(torch.from_numpy(kp), torch.from_numpy(up), port_spec(fs),
                                   a24, nbits)
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(tz.numpy(), np.asarray(jz))
    assert list(zip(ints(tx), ints(tz))) == [host_xladder(k, u, fs.p, a24, nbits)
                                             for k, u in zip(ks, us)]
    # the wrappers take the plain route for CPU tensors
    wx, wz = mladder.mladder_planes(torch.from_numpy(kp), torch.from_numpy(up), port_spec(fs),
                                    a24, nbits)
    assert torch.equal(wx, tx) and torch.equal(wz, tz)


def test_xdivz_plain_zero_lanes():
    fs = port_spec(W25519_FIELD)
    xs, zs = [5, 7, 0, P - 1], [3, 0, 0, 2]
    got = ints(mladder.xdivz(tplanes(xs, 16), tplanes(zs, 16), fs))
    assert got == [x * pow(z, P - 2, P) % P for x, z in zip(xs, zs)]
    assert got[1] == got[2] == 0


def test_derive_public_and_exchange_vs_cryptography():
    rng = np.random.default_rng(61)
    ks = [rng.bytes(32) for _ in range(3)]
    pubs = x25519.derive_public_batch(ks, device="cpu")
    keys = [X25519PrivateKey.from_private_bytes(k) for k in ks]
    assert pubs == [k.public_key().public_bytes_raw() for k in keys]
    # k_i with the next party's public key, and that party's key with Q_i,
    # in one batch
    peers = pubs[1:] + pubs[:1]
    got = x25519.x25519_batch(ks + ks[1:] + ks[:1], peers + pubs, device="cpu")
    assert got[:3] == [k.exchange(X25519PublicKey.from_public_bytes(q))
                       for k, q in zip(keys, peers)]
    assert got[3:] == got[:3]


def test_wei25519_base_tables_equal_jax():
    tables, negbase = tcomb.base_tables(port_spec(WEI25519), WEI25519.gx, WEI25519.gy)
    jtables, jnegbase = jcomb.base_tables(WEI25519, WEI25519.gx, WEI25519.gy)
    np.testing.assert_array_equal(tables, jtables)
    assert negbase == jnegbase
    assert tcomb.limb_layout(tables).shape == (256 + 31 * 128, 16)


def test_kernels_refuse_cpu_tensors_and_other_instances():
    fs = port_spec(W25519_FIELD)
    s = tplanes([8], 16)
    with pytest.raises(ValueError, match="CUDA"):
        tcomb.comb_planes(s, s, s, port_spec(WEI25519))
    with pytest.raises(NotImplementedError, match="X25519's ladder"):
        mladder._check_instance(fs, 5, 255)
    mladder._check_instance(fs, x25519.A24, 255)


def test_clamp_decode_and_byte_planes_equal_jax():
    from ecsimd_tpu import x25519 as jx25519

    rng = np.random.default_rng(62)
    raw = [rng.bytes(32) for _ in range(6)] + [b"\xff" * 32, bytes(32)]
    for b in raw:
        assert x25519.clamp(b) == jx25519.clamp(b)
        assert x25519.decode_u(b) == jx25519.decode_u(b)
    assert ints(x25519._byte_planes(raw, True, "cpu")) == [x25519.clamp(b) for b in raw]
    assert ints(x25519._byte_planes(raw, False, "cpu")) == [x25519.decode_u(b) for b in raw]
    assert x25519._bytes(tplanes([x25519.decode_u(b) for b in raw], 16)) == [
        x25519.decode_u(b).to_bytes(32, "little") for b in raw]
    with pytest.raises(ValueError, match="32 bytes"):
        x25519._byte_planes([bytes(31)], True, "cpu")
