"""Shared helpers for the PyTorch port's tests (tests/test_torch_*.py).

Inputs are drawn from numpy.random.default_rng(seed) and handed to both the
JAX package and the port as the same int32 planes."""

import dataclasses

import numpy as np
import torch

from ecsimd_tpu import convert
from ecsimd_tpu import specs as jspecs
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
