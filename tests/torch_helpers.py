"""Shared helpers for the PyTorch port's tests (tests/test_torch_*.py).

Inputs are drawn from numpy.random.default_rng(seed) and handed to both the
JAX package and the port as the same int32 planes."""

import dataclasses

import numpy as np
import torch

from ecsimd_tpu import convert
from ecsimd_tpu import specs as jspecs
from ecsimd_tpu.oracle import coz as ocoz
from ecsimd_tpu.oracle import window as ow
from ecsimd_tpu_torch import specs as tspecs


def port_spec(spec):
    """A reference FieldSpec or CurveSpec (``ecsimd_tpu.specs``,
    ``tests/toy.py``) rebuilt field by field as the port's own spec type.
    The two packages' frozen dataclasses never compare equal, and the port
    keys its ``curve != P256`` checks and its caches on its own type."""
    if isinstance(spec, tspecs.FieldSpec | tspecs.CurveSpec):
        return spec
    kw = {f.name: getattr(spec, f.name) for f in dataclasses.fields(spec)}
    if isinstance(spec, jspecs.FieldSpec):
        return tspecs.FieldSpec(**kw)
    assert isinstance(spec, jspecs.CurveSpec), type(spec)
    kw["field"] = port_spec(spec.field)
    return tspecs.CurveSpec(**kw)


def rand_ints(rng, bound: int, n: int, edges=()):
    """``edges`` followed by uniform ints in [0, bound), n in all."""
    nbytes = (bound.bit_length() + 7) // 8 + 8
    vals = list(edges) + [int.from_bytes(rng.bytes(nbytes), "little") % bound for _ in range(n)]
    return vals[:n]


def planes(ints, d: int):
    """Python ints -> (d, n) int32 numpy planes."""
    return convert.ints_to_planes(ints, d)


def tplanes(ints, d: int):
    """Python ints -> (d, n) int32 torch planes on the CPU."""
    return torch.from_numpy(planes(ints, d))


def ints(t):
    """(d, n) planes (torch, jax or numpy) -> Python ints."""
    if isinstance(t, torch.Tensor):
        t = t.cpu().numpy()
    return convert.planes_to_ints(np.asarray(t))


def multiples(curve, n: int):
    """Affine (i+1)*G for i < n, by oracle Jacobian adds."""
    p = curve.p
    jacs = [(curve.gx, curve.gy, 1)]
    if n > 1:
        jacs.append(ow._jac_dbl(jacs[0], curve))
    for _ in range(n - 2):
        jacs.append(ow._jac_add(jacs[-1], jacs[0], curve))
    out = []
    for x, y, z in jacs:
        zi = pow(z, p - 2, p)
        out.append((x * zi * zi % p, y * zi * zi * zi % p))
    return out


# --- the comb's schedules composed on Python ints (plain-domain fields) -----------


def comb_entry_ints(k: int, tables):
    """The comb table entries of scalar k, position by position, as (x, y)
    ints: entry e_i = bits 8i .. 8i+8 of k, shifted right by one, of the
    (npos, 256, 2D) digit tables (internal form, which is classical on the
    plain-domain fields these helpers serve)."""
    d = tables.shape[2] // 2

    def value(row):
        return sum(int(v) << (16 * j) for j, v in enumerate(row))

    return [(value(tables[i, e, :d]), value(tables[i, e, d:]))
            for i, e in ((i, ((k >> (8 * i)) & 0x1FF) >> 1) for i in range(tables.shape[0]))]


def affine_ints(triples, p: int):
    """Jacobian (x, y, z) int triples -> affine (x / z^2, y / z^3) pairs."""
    out = []
    for x, y, z in triples:
        zi = pow(z, -1, p)
        out.append((x * zi * zi % p, y * zi * zi * zi % p))
    return out


def _comb_fixup(k, acc, negbase, curve):
    return acc if k & 1 else ocoz.add_z2_1(acc, (*negbase, 1), curve)


def oracle_comb_tree(k: int, tables, negbase, curve):
    """The JAX package's comb tree (``_tree_core``) on Python ints: level 1
    adds entry i to entry i + npos/2 (the general add with z = 1), each
    further level node i to node i + n/2, an odd last node passing on; then
    the parity fix-up. The exact Jacobian triple; raises ZeroDivisionError
    on a degenerate add."""
    ents = comb_entry_ints(k, tables)
    h = len(ents) // 2
    nodes = [ow._jac_add((*ents[i], 1), (*ents[i + h], 1), curve) for i in range(h)]
    while len(nodes) > 1:
        m = len(nodes) // 2
        nodes = [ow._jac_add(nodes[i], nodes[i + m], curve) for i in range(m)] + nodes[2 * m:]
    return _comb_fixup(k, nodes[0], negbase, curve)


def oracle_comb_chains(k: int, tables, negbase, curve, chains: int):
    """The JAX package's multi-chain comb (``_comb_kernel``, chains > 1) on
    Python ints: chain c seeds from its first position with z = 1 and adds
    the rest with ADD_Z2_1; the chains combine left to right with the
    general add; then the parity fix-up. The exact Jacobian triple."""
    ents = comb_entry_ints(k, tables)
    per = len(ents) // chains
    accs = []
    for c in range(chains):
        acc = (*ents[c * per], 1)
        for x, y in ents[c * per + 1:(c + 1) * per]:
            acc = ocoz.add_z2_1(acc, (x, y, 1), curve)
        accs.append(acc)
    acc = accs[0]
    for a in accs[1:]:
        acc = ow._jac_add(acc, a, curve)
    return _comb_fixup(k, acc, negbase, curve)
