"""The port's 256-bit curves on the card's routes, checked without a card.

* Kernel A's wrapper hands the kernel the point's coordinates in the
  field's internal form: ``ladder.scalar_mult``'s card route, with
  ``ladder_planes`` stubbed by the plain ladder on the planes it is handed,
  gives ``api.scalar_mult`` on secp256k1 (Montgomery form) the oracle's
  points.
* The plain ladder on the general-a Montgomery toy curve TOYA5 equals the
  JAX package's XLA ladder (``ladder_xla_planes``) plane for plane.
* The CUDA sources, read as text: each namespace's curve a equals the
  spec's a in the field's internal form; no lane builds the field's 1 from
  a bare word (on secp256k1 the 1 is R mod p); every kernel table entry is
  an ``extern "C"`` entry of its source.
* The wrappers of kernels A, B, D, E, J, K and L cover P-256, secp256k1,
  Wei25519, P-384 and P-521, in every mode the JAX package runs, and hand
  a P-384 / P-521 launch its own kernel and (24, B) / (33, B) planes.

Tolerance: exact."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecsimd_tpu.kernels import ladder as jladder
from ecsimd_tpu.oracle import coz as ocoz
from ecsimd_tpu.specs import SECP256K1 as JSECP256K1
from ecsimd_tpu_torch import api
from ecsimd_tpu_torch.curves import group
from ecsimd_tpu_torch.curves.point import AffinePoint, JacobianPoint
from ecsimd_tpu_torch.field import GFp
from ecsimd_tpu_torch.kernels import _build, affine, comb, ladder, window
from ecsimd_tpu_torch.specs import P256, P384, P521, SECP256K1, WEI25519
from tests.toy import TOYA5
from tests.torch_helpers import ints, multiples, planes, port_spec, rand_ints, tplanes

ROOT = Path(__file__).resolve().parent.parent
CURVES = (P256, SECP256K1, WEI25519)
WIDE = (P384, P521)
TTOYA5 = port_spec(TOYA5)


class _CardLike:
    """CPU scalar planes that report a CUDA device, so that a wrapper takes
    its kernel route (whose kernel the test stubs)."""

    device = torch.device("cuda", 0)

    def __init__(self, planes):
        self._planes = planes

    def contiguous(self):
        return self._planes


def _plain_ladder_planes(scalars, xm, ym, curve):
    """What kernel A computes, on the planes it is handed: the plain ladder
    with those planes as the field's internal form."""
    fs = curve.field
    x = GFp(xm, fs)
    out = group.scalar_mult(scalars, JacobianPoint(x, GFp(ym, fs), GFp.one(fs, xm), curve))
    return out.x.planes, out.y.planes, out.z.planes


def test_ladder_card_route_secp256k1_vs_oracle(monkeypatch):
    """api.scalar_mult through ladder.scalar_mult's kernel route on
    secp256k1: k in {1, 2, random} on G and 2G."""
    monkeypatch.setattr(ladder, "ladder_planes", _plain_ladder_planes)
    n = SECP256K1.order
    ks = [1, 2] + [k + 1 for k in rand_ints(np.random.default_rng(170), n - 2, 1)]
    pts = multiples(JSECP256K1, 2)
    lanes = [(k, pt) for pt in pts for k in ks]
    s = tplanes([k for k, _ in lanes], 16)
    pt = AffinePoint(tplanes([x for _, (x, _) in lanes], 16),
                     tplanes([y for _, (_, y) in lanes], 16), SECP256K1)
    out = api.scalar_mult(_CardLike(s), pt)
    assert list(zip(ints(out.x), ints(out.y))) == [
        ocoz.scalar_mult_affine(k, x, y, JSECP256K1) for k, (x, y) in lanes]


def test_plain_ladder_toya5_matches_jax_xla_ladder():
    """The port's plain ladder (ladder.scalar_mult on CPU tensors) on the
    a = 5 Montgomery toy against ladder_xla_planes: one JAX jit."""
    rng = np.random.default_rng(171)
    d = TOYA5.field.ndigits
    ks = [1, 2, 5] + [k + 1 for k in rand_ints(rng, TOYA5.order - 2, 5)]
    pts = multiples(TOYA5, len(ks))
    xs, ys = [x for x, _ in pts], [y for _, y in pts]
    got = ladder.scalar_mult(tplanes(ks, d), AffinePoint(tplanes(xs, d), tplanes(ys, d), TTOYA5))
    xm = GFp.from_classical(tplanes(xs, d), TTOYA5.field).planes
    ym = GFp.from_classical(tplanes(ys, d), TTOYA5.field).planes
    want = jladder.ladder_xla_planes(jnp.asarray(planes(ks, d)), jnp.asarray(xm.numpy()),
                                     jnp.asarray(ym.numpy()), TOYA5)
    for t, j in zip((got.x, got.y, got.z), want):
        np.testing.assert_array_equal(t.planes.numpy(), np.asarray(j))


# --- the CUDA sources as text -------------------------------------------------------

CSRC = ROOT / "ecsimd_tpu_torch" / "csrc"


@pytest.mark.parametrize("header, macro, curve", [
    ("coz_p256.cuh", "P256_A", P256), ("coz_secp256k1.cuh", "SECP256K1_A", SECP256K1),
    ("coz_w25519.cuh", "WEI25519_A", WEI25519), ("coz_p384.cuh", "P384_A", P384),
    ("coz_p521.cuh", "P521_A", P521)], ids=lambda v: getattr(v, "name", None))
def test_curve_a_in_internal_form(header, macro, curve):
    """The a each namespace hands coz.cuh's DBLU (and Wei25519's doubling):
    the field's 32-bit words (8; 12 on P-384, 17 on P-521), least
    significant first, equal to the spec's a in the field's internal form."""
    text = (CSRC / header).read_text()
    m = re.search(rf"#define {macro}\s*\\\s*\{{([^}}]*)\}}", text)
    assert m, f"{header}: no {macro}"
    words = [int(w.strip().rstrip("u"), 16 if "x" in w else 10)
             for w in m[1].replace("\\", " ").split(",")]
    d = curve.field.ndigits
    assert len(words) == (d + 1) // 2
    value = sum(w << (32 * i) for i, w in enumerate(words))
    like = torch.zeros((d, 1), dtype=torch.int32)
    assert value == ints(GFp.constant(curve.a, curve.field, like).planes)[0]
    assert f"const fe a = {{{macro}}};" in text and '#include "coz.cuh"' in text


def test_no_lane_builds_the_field_one_from_a_word():
    """z = 1 is fe_one(), the field's 1: on secp256k1's Montgomery field
    fe_from_u32(1u) is R^-1. Only the field layers define fe_one()."""
    for f in sorted(CSRC.glob("*.cu*")):
        if f.name.startswith(("field_", "limbs")):
            continue
        assert not re.search(r"fe_from_u32\(\s*1u?\s*\)", f.read_text()), f.name


TABLES = {
    "ladder": ladder.KERNELS, "window": window.KERNELS, "comb": comb.KERNELS,
    "comb_tree": comb.KERNELS_TREE, "comb_pipe": comb.KERNELS_PIPE,
    "comb_general": comb.KERNELS_GENERAL,
    "affine": affine.KERNELS,
}
# the modes the JAX package runs each kernel in, on every curve
MODES = {
    "ladder": {()}, "window": {(False,), (True,)}, "comb": {(False,), (True,)},
    "comb_tree": {()}, "comb_pipe": {()}, "comb_general": {(False,), (True,)}, "affine": {()},
}


def _curve_and_mode(key):
    return (key, ()) if not isinstance(key, tuple) else (key[0], tuple(key[1:]))


@pytest.mark.parametrize("table", sorted(TABLES))
def test_kernel_table_covers_the_256_bit_curves(table):
    """Each table holds one kernel for every (curve, mode) it covers and
    nothing else — A, B, D, E, J, K and L the three 256-bit curves, P-384
    and P-521 — each an extern "C" entry of its named source (J's, K's and
    L's, and the wide B's and E's, with their _smem query; B's, J's, K's and
    L's also with their _blocks query), with distinct symbols."""
    kernels = TABLES[table]
    keys = {_curve_and_mode(k) for k in kernels}
    assert keys == {(c, m) for c in CURVES + WIDE for m in MODES[table]}
    assert len({k.symbol for k in kernels.values()}) == len(kernels)
    for k in kernels.values():
        text = (ROOT / k.source).read_text()
        assert f'extern "C" int {k.symbol}(' in text, k.symbol
        if table in ("comb_tree", "comb_pipe", "comb_general") or (
                table in ("comb", "window") and k.source.endswith(("_p384.cu", "_p521.cu"))):
            assert f'extern "C" int {k.symbol}_smem(void)' in text, k.symbol
        if table in ("comb", "comb_tree", "comb_pipe", "comb_general"):
            assert f'extern "C" int {k.symbol}_blocks(void)' in text, k.symbol


def _wrapper_calls(curve):
    """One call of each CUDA wrapper on ``curve``, CPU tensors of its shape."""
    d = curve.field.ndigits
    z = torch.zeros((d, 4), dtype=torch.int32)
    npos = curve.field.nbits // comb.W
    kept = comb.NENT + (npos - 1) * comb.NENT // 2
    mma = torch.zeros(kept * comb.mma_entry_bytes(d), dtype=torch.uint8)
    nb = torch.zeros(2 * d, dtype=torch.int32)
    return {
        "ladder": lambda: ladder.ladder_planes(z, z, z, curve),
        "window": lambda: window.window_planes(z, z, z, curve),
        "window_strict": lambda: window.window_planes(z, z, z, curve, strict=True),
        "comb": lambda: comb.comb_planes(z, mma, nb, curve),
        "comb_strict": lambda: comb.comb_planes(z, mma, nb, curve, strict=True),
        "comb_tree": lambda: comb.comb_tree_planes(z, mma, nb, curve),
        "comb_pipe": lambda: comb.comb_pipe_planes(z, mma, nb, curve),
        "comb_chains": lambda: comb.comb_general_planes(z, mma, nb, curve, 2, 1),
        "affine": lambda: affine.affine_planes(z, z, z, curve),
    }


# the wrappers on P-384 and P-521 -> the stem of their kernel's C name and
# its ints (the generic kernel L: chains 2, unroll 1)
SLOTS = 128  # the resident threads the test hands the wide kernel E
WIDE_ROUTES = {"ladder": ("ladder", ()), "window": ("window", (SLOTS,)),
               "window_strict": ("window", (SLOTS,)), "comb": ("comb", ()),
               "comb_strict": ("comb", ()),
               "comb_tree": ("comb_tree", ()), "comb_pipe": ("comb_pipe", ()),
               "comb_chains": ("comb_general", (2, 1)), "affine": ("affine", ())}


@pytest.mark.parametrize("curve", [P384, P521], ids=lambda c: c.name)
@pytest.mark.parametrize("wrapper", sorted(_wrapper_calls(P256)))
def test_wrappers_raise_on_the_wider_curves(monkeypatch, wrapper, curve):
    """On P-384 and P-521 (the tensors' device check passed by stubbing)
    every wrapper takes the card route — kernels A, B (both modes), D, E
    (both modes), J (tree), K (pipe) and L (chains 2: the generic kernel,
    handed chains and unroll as ints): one launch of the curve's own kernel,
    ``ec_<kind>_<tag>[_strict]``, handed (24, B) / (33, B) planes (the
    comb's tables: B's, J's, K's and the generic L's in the u8 layout; E
    also its scratch, one column a resident thread, and the slot count as
    an int), counted once. None raises."""
    monkeypatch.setattr(_build, "require_cuda", lambda t, what: None)
    monkeypatch.setattr(window, "resident_slots", lambda kernel, curve, device: SLOTS)
    calls = []
    monkeypatch.setattr(_build, "launch", lambda kernel, tensors, batch, *ints:
                        calls.append((kernel, tensors, batch, ints)))
    tag = _build.CURVE_TAGS[curve][0]
    d = curve.field.ndigits
    _wrapper_calls(curve)[wrapper]()
    (kernel, tensors, batch, ints_), = calls
    strict = "_strict" if wrapper.endswith("_strict") else ""
    stem, want_ints = WIDE_ROUTES[wrapper]
    assert kernel.symbol == f"ec_{stem}_{tag}{strict}" and ints_ == want_ints
    assert kernel.launches >= 1 and batch == 4
    shapes = [tuple(t.shape) for t in tensors]
    if wrapper.startswith("comb"):
        npos = curve.field.nbits // comb.W
        kept = comb.NENT + (npos - 1) * comb.NENT // 2
        table = (kept * comb.mma_entry_bytes(d),)
        assert shapes == [(d, 4), table, (2 * d,)] + [(d, 4)] * 3
    elif wrapper.startswith("window"):
        assert shapes == [(d, 4)] * 6 + [(window.table_split(curve).scratch_vecs, SLOTS, 4)]
    else:
        assert shapes == [(d, 4)] * kernel.n_pointers
