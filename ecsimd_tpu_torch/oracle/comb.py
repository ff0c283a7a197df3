"""The fixed-base comb's schedules composed on Python ints.

For one scalar, the exact Jacobian triple that each non-strict schedule of
``kernels/comb`` computes — the serial chain or ``n`` chains, and the
pairwise tree — with the same adds, operands and order, so that a kernel's
planes can be held to it bit for bit and the lanes where a schedule meets a
degenerate add (equal or opposite x) can be found: every add here raises
``ZeroDivisionError`` there. ``tables`` and ``negbase`` are what
``kernels.comb.base_tables`` returns, on a field whose internal form is the
plain value (``fs.plain``: P-256, the toy curves).
"""

from __future__ import annotations

from ecsimd_tpu_torch.oracle import coz
from ecsimd_tpu_torch.oracle.window import _jac_add
from ecsimd_tpu_torch.specs import CurveSpec

Jac = tuple[int, int, int]


def entry_ints(k: int, tables) -> list[tuple[int, int]]:
    """Scalar k's table entries, position by position, as affine (x, y)
    ints: position i reads entry (bits 8i .. 8i + 8 of k) >> 1 of the
    (npos, 256, 2D) digit tables."""
    d = tables.shape[2] // 2

    def value(row):
        return sum(int(v) << (16 * j) for j, v in enumerate(row))

    return [(value(tables[i, e, :d]), value(tables[i, e, d:]))
            for i, e in ((i, ((k >> (8 * i)) & 0x1FF) >> 1) for i in range(tables.shape[0]))]


def add_z2_1(acc: Jac, pt: Jac, curve: CurveSpec) -> Jac:
    """``coz.add_z2_1`` (``pt`` has z = 1), raising ZeroDivisionError where
    H = x2 z1^2 - x1 is 0, as ``_jac_add`` does."""
    x1, _, z1 = acc
    if (pt[0] * z1 * z1 - x1) % curve.p == 0:
        raise ZeroDivisionError("degenerate add (equal or opposite x)")
    return coz.add_z2_1(acc, pt, curve)


def _fixup(k: int, acc: Jac, negbase, curve: CurveSpec) -> Jac:
    return acc if k & 1 else add_z2_1(acc, (*negbase, 1), curve)


def chains(k: int, tables, negbase, curve: CurveSpec, n: int = 1) -> Jac:
    """The serial comb with ``n`` chains (``_comb_kernel``): chain c seeds
    from position c * npos / n with z = 1 and adds the rest of its positions
    in order with ADD_Z2_1; the chains combine left to right with the
    general add; then the parity fix-up. ``n = 1`` is the serial comb."""
    ents = entry_ints(k, tables)
    per = len(ents) // n
    accs = []
    for c in range(n):
        acc = (*ents[c * per], 1)
        for x, y in ents[c * per + 1:(c + 1) * per]:
            acc = add_z2_1(acc, (x, y, 1), curve)
        accs.append(acc)
    acc = accs[0]
    for a in accs[1:]:
        acc = _jac_add(acc, a, curve)
    return _fixup(k, acc, negbase, curve)


def tree(k: int, tables, negbase, curve: CurveSpec) -> Jac:
    """The comb tree (``_tree_core``): level 1 adds entry i to entry
    i + npos / 2 (the general add with z = 1), each further level node i to
    node i + n / 2, an odd last node passing on; then the parity fix-up."""
    ents = entry_ints(k, tables)
    h = len(ents) // 2
    nodes = [_jac_add((*ents[i], 1), (*ents[i + h], 1), curve) for i in range(h)]
    while len(nodes) > 1:
        m = len(nodes) // 2
        nodes = [_jac_add(nodes[i], nodes[i + m], curve) for i in range(m)] + nodes[2 * m:]
    return _fixup(k, nodes[0], negbase, curve)
