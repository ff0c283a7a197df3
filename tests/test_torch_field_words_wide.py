"""Word-level models of the CUDA field layers of P-384 and P-521
(ecsimd_tpu_torch/csrc/limbs.cuh's 12- and 17-word chains, mul_wide.cuh,
field_p384.cuh, field_p521.cuh), instruction for instruction, on Python ints.

The kernels run only on the card, so these models are the check of the
algorithms before any card time. The long chains (limbs.cuh's add12, sub12,
add17 and sub17, and field_p384.cuh's whole Solinas reduction) are not
transcribed by hand: ``Asm`` below reads each asm statement's text out of the
header and runs it, one PTX instruction at a time, on the operands the C++
code hands it (mov.b64 packing and unpacking included), keeping the carry
flag and asserting that every 32-bit register holds a 32-bit word. So what
is checked is the text nvcc compiles; so are mul_wide.cuh's square-adding
chains. mul_wide.cuh's Comba columns (mul256.cuh's mac) and funnel-shift
doubling and field_p521.cuh's fold are transcribed, as
tests/test_torch_field_words.py does for the 8-word layer. Each model is
held to modular arithmetic on ints on edge operands (0, 1, p - 1, (p - 1)^2
as a product, words of all ones, P-521's 9-bit top word) and on seeded
random draws. Tolerance: exact.
"""

import random
import re
from pathlib import Path

import pytest

from ecsimd_tpu_torch.specs import P384, P521

CSRC = Path(__file__).resolve().parent.parent / "ecsimd_tpu_torch" / "csrc"
M32 = 0xFFFFFFFF
P384_P = P384.field.p
P521_P = P521.field.p
FIELDS = {"p384": (P384_P, 12), "p521": (P521_P, 17)}


def _function(header: str, signature: str) -> str:
    """The text of the function of ``header`` whose definition starts with
    ``signature``, up to its closing brace at column 0."""
    text = (CSRC / header).read_text()
    start = text.index(signature)
    return text[start:text.index("\n}\n", start) + 2]


def _asm_statements(body: str):
    """(template, operand constraints) of each asm statement of ``body``:
    the template is the concatenation of the string literals before the
    first top-level colon, the constraints those of the operand lists."""
    out = []
    for m in re.finditer(r"\basm\(", body):
        rest = body[m.end():]
        end = rest.index(");")
        stmt = rest[:end]
        parts = re.split(r'(?<=")\s*:\s*', stmt, maxsplit=1)
        template = "".join(re.findall(r'"((?:[^"\\]|\\.)*)"', parts[0]))
        template = template.replace("\\n", "\n").replace("\\t", "")
        constraints = re.findall(r'"([=+&]*[rln])"\s*\(', parts[1]) if len(parts) > 1 else []
        out.append((template, constraints))
    return out


class Asm:
    """One asm statement's PTX, run on Python ints: add.cc / addc(.cc) /
    sub.cc / subc(.cc) on .u32 with the carry flag CC.CF (sub.cc and subc
    set it on a borrow, as PTX does), and mov.b64 packing two 32-bit
    registers into a 64-bit operand or unpacking one. %k is operand k;
    other names are the statement's own .reg registers."""

    def __init__(self, template: str):
        self.lines = []
        for raw in template.split("\n"):
            line = raw.strip().rstrip(";").strip()
            if line in ("", "{", "}") or line.startswith(".reg"):
                continue
            op, args = line.split(None, 1)
            self.lines.append((op, [a.strip() for a in re.split(r",(?![^{]*\})", args)]))

    def run(self, operands):
        ops = list(operands)
        regs = {}
        cf = 0

        def val(tok):
            if tok.startswith("%"):
                return ops[int(tok[1:])]
            if tok in regs:
                return regs[tok]
            return int(tok, 0)

        def word(tok):
            v = val(tok)
            assert 0 <= v <= M32, (tok, hex(v))
            return v

        def put(tok, v):
            if tok.startswith("%"):
                ops[int(tok[1:])] = v
            else:
                regs[tok] = v

        for op, args in self.lines:
            if op == "mov.b64":
                dst, src = args
                if dst.startswith("{"):  # unpack
                    lo, hi = (t.strip() for t in dst.strip("{}").split(","))
                    v = val(src)
                    assert 0 <= v < 1 << 64
                    put(lo, v & M32)
                    put(hi, v >> 32)
                else:  # pack
                    lo, hi = (t.strip() for t in src.strip("{}").split(","))
                    put(dst, word(lo) | (word(hi) << 32))
                continue
            d, a, b = args
            a, b = word(a), word(b)
            kind, cc = op.split(".u32")[0], op.endswith(".cc.u32")
            if kind in ("add.cc", "addc.cc", "addc"):
                s = a + b + (cf if kind.startswith("addc") else 0)
                if kind.endswith(".cc"):
                    cf = s >> 32
                put(d, s & M32)
            elif kind in ("sub.cc", "subc.cc", "subc"):
                s = a - b - (cf if kind.startswith("subc") else 0)
                if kind.endswith(".cc"):
                    cf = int(s < 0)
                put(d, s & M32)
            else:
                raise AssertionError(f"unmodelled instruction {op}")
            assert cc == kind.endswith(".cc")
        return ops


def words(x, n):
    assert 0 <= x < 1 << (32 * n), hex(x)
    return [(x >> (32 * i)) & M32 for i in range(n)]


def value(ws):
    return sum(w << (32 * i) for i, w in enumerate(ws))


def pairs(ws):
    return [ws[2 * j] | (ws[2 * j + 1] << 32) for j in range(len(ws) // 2)]


def unpairs(ps):
    return [w for p in ps for w in (p & M32, p >> 32)]


# the asm statements as the headers hold them, each parsed once
CHAINS = {
    (n, op): _asm_statements(_function("limbs.cuh", f"__device__ __forceinline__ uint32_t {op}{n}("))
    for n in (12, 17) for op in ("add", "sub")
}
REDUCE384 = _asm_statements(_function("field_p384.cuh", "__device__ __forceinline__ fe fe_reduce("))
SQUARE = _asm_statements(_function("mul_wide.cuh", "__device__ __forceinline__ void sqr_wide_n("))
RUN = {k: Asm(v[0][0]) for k, v in CHAINS.items()} | {"reduce384": Asm(REDUCE384[0][0]),
                                                       "square": Asm(SQUARE[0][0])}


def chain(op, a, b, x=0):
    """limbs.cuh's add12 / sub12 / add17 / sub17 on word lists: (r, c),
    c the carry out (add) or x - borrow (sub), operands packed as the C++
    code packs them (word 16 alone at 17 words)."""
    n = len(a)
    if n == 12:
        ops = [0] * 7 + pairs(a) + pairs(b) + ([x] if op == "sub" else [])
        out = RUN[(12, op)].run(ops)
        return unpairs(out[:6]), out[6]
    ops = [0] * 10 + pairs(a[:16]) + [a[16]] + pairs(b[:16]) + [b[16]] + (
        [x] if op == "sub" else [])
    out = RUN[(17, op)].run(ops)
    return unpairs(out[:8]) + [out[8]], out[9]


def cond_sub(a, carry, p):
    """limbs.cuh:fe_cond_sub — a - p when carry or a >= p, else a: the sub
    chain's carry - borrow word, its sign spread as the keep-a mask."""
    t, m = chain("sub", a, words(p, len(a)), carry)
    keep_a = M32 if m >> 31 else 0
    return [(aj & keep_a) | (tj & ~keep_a & M32) for aj, tj in zip(a, t)]


def add_mod(a, b, p):
    s, c = chain("add", a, b)
    return cond_sub(s, c, p)


def sub_mod(a, b, p):
    d, m = chain("sub", a, b)
    pm = [w & m for w in words(p, len(a))]
    return chain("add", d, pm)[0]


def neg_mod(a, p):
    d, _ = chain("sub", words(p, len(a)), a)
    nz = M32 if any(a) else 0
    return [w & nz for w in d]


def mac(acc, a, b):
    """mul256.cuh:mac — mad.lo.cc, madc.hi.cc, addc into (c0, c1, c2)."""
    s = acc[0] + ((a * b) & M32)
    c0, cf = s & M32, s >> 32
    s = acc[1] + ((a * b) >> 32) + cf
    c1, cf = s & M32, s >> 32
    c2 = acc[2] + cf
    assert c2 <= M32
    return [c0, c1, c2]


def mul_wide_n(a, b):
    """mul_wide.cuh:mul_wide_n — the Comba columns, N x N -> 2N words."""
    n = len(a)
    out, acc = [], [0, 0, 0]
    for k in range(2 * n - 1):
        for i in range(max(0, k - (n - 1)), min(k, n - 1) + 1):
            acc = mac(acc, a[i], b[k - i])
        out.append(acc[0])
        acc = [acc[1], acc[2], 0]
    assert acc[1] == 0
    return out + [acc[0]]


def sqr_wide_n(a):
    """mul_wide.cuh:sqr_wide_n — the cross products once by columns, the
    doubling by funnel shifts, then each square a_i^2 added at words 2i,
    2i + 1 by its asm statement, run from the header's text: the carry of
    the previous square into the flag (add.cc of it and 2^32 - 1), the two
    words, the carry out."""
    n = len(a)
    t, acc = [0], [0, 0, 0]
    for k in range(1, 2 * n - 2):
        for i in range(max(0, k - (n - 1)), (k + 1) // 2):
            acc = mac(acc, a[i], a[k - i])
        t.append(acc[0])
        acc = [acc[1], acc[2], 0]
    assert acc[2] == 0 and acc[1] < 1 << 31  # the triangle is below 2^(64n - 1)
    t += acc[:2]
    c = [0] + [((t[k] << 1) | (t[k - 1] >> 31)) & M32 for k in range(1, 2 * n)]
    cy = 0
    for i in range(n):
        q = a[i] * a[i]
        c[2 * i], c[2 * i + 1], cy, _, _ = RUN["square"].run(
            [c[2 * i], c[2 * i + 1], cy, q & M32, q >> 32])
    assert cy == 0
    return c


def reduce384(c):
    """field_p384.cuh:fe_reduce — its asm statement (the Solinas sum plus
    2p, the fold of the top word), then the conditional subtract."""
    out = RUN["reduce384"].run([0] * 7 + pairs(c))
    r, hi = unpairs(out[:6]), out[6]
    assert hi <= 1 and value(r) + (hi << 384) < 2 * P384_P
    return cond_sub(r, hi, P384_P)


def reduce521(c):
    """field_p521.cuh:fe_reduce — lo = c mod 2^521, hi = c >> 521 by funnel
    shifts (word j: c[16 + j] >> 9 | c[17 + j] << 23), add17, then the
    conditional subtract."""
    lo = c[:16] + [c[16] & 0x1FF]
    hi = [((c[16 + j] >> 9) | (c[17 + j] << 23)) & M32 for j in range(17)]
    s, carry = chain("add", lo, hi)
    assert carry == 0 and value(s) < 2 * P521_P
    return cond_sub(s, carry, P521_P)


REDUCE = {"p384": reduce384, "p521": reduce521}


def fe_mul(field, a, b):
    p, n = FIELDS[field]
    return value(REDUCE[field](mul_wide_n(words(a, n), words(b, n))))


def fe_sqr(field, a):
    p, n = FIELDS[field]
    return value(REDUCE[field](sqr_wide_n(words(a, n))))


def _edges(field):
    p, n = FIELDS[field]
    vals = [0, 1, 2, p - 1, p - 2, p >> 1, (p >> 1) + 1, p - M32, M32, (1 << 32), (1 << 383) % p,
            sum(M32 << (64 * i) for i in range(n // 2)) % p]
    if field == "p521":  # the 9-bit top word: full, one bit, empty under full words
        vals += [0x1FF << 512, 1 << 512, (1 << 512) - 1, (1 << 520) + (1 << 511)]
    else:
        vals += [(1 << 384) - 1 - p + (p - 1) // 3]
    return sorted({v % p for v in vals})


def _random(field, n, seed):
    rng = random.Random(seed)
    p, _ = FIELDS[field]
    return [rng.randrange(p) for _ in range(n)]


# -- the text: one asm statement a chain, at most 30 operands ---------------------


@pytest.mark.parametrize("header, signature", [
    ("limbs.cuh", "__device__ __forceinline__ uint32_t add12("),
    ("limbs.cuh", "__device__ __forceinline__ uint32_t sub12("),
    ("limbs.cuh", "__device__ __forceinline__ uint32_t add17("),
    ("limbs.cuh", "__device__ __forceinline__ uint32_t sub17("),
    ("field_p384.cuh", "__device__ __forceinline__ fe fe_reduce("),
], ids=["add12", "sub12", "add17", "sub17", "p384_reduce"])
def test_each_chain_is_one_asm_statement(header, signature):
    """The carry flag does not live from one asm statement to the next, so
    each chain is one statement; its operands, '+' ones counted twice (as
    GCC-style inline asm counts them), are at most 30; every carry chain in
    it starts with an instruction that sets the flag without reading it."""
    stmts = _asm_statements(_function(header, signature))
    assert len(stmts) == 1
    template, constraints = stmts[0]
    assert sum(2 if c.startswith("+") else 1 for c in constraints) <= 30
    ops = [line.split()[0] for line in template.split("\n")
           if line.strip() and not line.strip().startswith((".reg", "{", "}", "mov"))]
    for prev, op in zip(["none"] + ops, ops):
        if op.startswith(("addc", "subc")):
            assert prev.endswith(".cc.u32"), (prev, op)


def test_every_new_asm_statement_stays_within_30_operands():
    """Every asm statement of the P-384 / P-521 headers (the squares' chain
    of mul_wide.cuh included) has at most 30 operands."""
    for header in ("limbs.cuh", "mul_wide.cuh", "field_p384.cuh", "field_p521.cuh"):
        for template, constraints in _asm_statements((CSRC / header).read_text()):
            assert sum(2 if c.startswith("+") else 1 for c in constraints) <= 30, header


# -- the chains --------------------------------------------------------------------


@pytest.mark.parametrize("n", [12, 17])
def test_add_sub_chains(n):
    """add12 / add17: a + b mod 2^(32n) and its carry; sub12 / sub17: a - b
    mod 2^(32n) and x - borrow, on words of all ones, zeros and draws."""
    top = (1 << (32 * n)) - 1
    vals = [0, 1, top, top - 1, 1 << (32 * n - 1), M32, M32 << (32 * (n - 1))]
    vals += _random("p384" if n == 12 else "p521", 6, n)
    for a in vals:
        for b in vals:
            r, c = chain("add", words(a, n), words(b, n))
            assert value(r) + (c << (32 * n)) == a + b
            for x in (0, 1):
                r, m = chain("sub", words(a, n), words(b, n), x)
                assert value(r) == (a - b) % (1 << (32 * n))
                assert m == (x - int(a < b)) & M32


# -- the products and the reductions ------------------------------------------------


@pytest.mark.parametrize("n", [12, 17])
def test_comba_product_and_squaring(n):
    """mul_wide_n and sqr_wide_n: the 2n-word product and square of any
    n-word operands, words of all ones included."""
    top = (1 << (32 * n)) - 1
    vals = [0, 1, top, top >> 1, 1 << (32 * n - 1), M32] + _random("p384", 5, n) + [
        random.Random(n).randrange(1 << (32 * n)) for _ in range(5)]
    for a in vals:
        assert value(sqr_wide_n(words(a, n))) == a * a
        for b in vals:
            assert value(mul_wide_n(words(a, n), words(b, n))) == a * b


@pytest.mark.parametrize("field", ["p384", "p521"])
def test_reduction_extremes(field):
    """The reduction of any product of two residues, the largest, (p - 1)^2,
    included, and of products with a word of all ones in every place."""
    p, n = FIELDS[field]
    for t in [0, 1, p, (p - 1) ** 2, (p - 1) * (p - 2), p * (p - 1), (1 << (32 * n)) % p * (p - 1)]:
        assert value(REDUCE[field](words(t, 2 * n))) == t % p


@pytest.mark.parametrize("op", ["mul", "sqr"])
@pytest.mark.parametrize("field", ["p384", "p521"])
def test_mul_sqr_edges(field, op):
    p, _ = FIELDS[field]
    vals = _edges(field)
    for a in vals:
        if op == "sqr":
            assert fe_sqr(field, a) == a * a % p
        else:
            for b in vals:
                assert fe_mul(field, a, b) == a * b % p


@pytest.mark.parametrize("field", ["p384", "p521"])
def test_mul_sqr_random(field):
    p, _ = FIELDS[field]
    xs = _random(field, 40, 1)
    ys = _random(field, 40, 2)
    for a, b in zip(xs, ys):
        assert fe_mul(field, a, b) == a * b % p
        assert fe_sqr(field, a) == a * a % p


@pytest.mark.parametrize("field", ["p384", "p521"])
def test_modular_add_sub_neg(field):
    """limbs.cuh's add, sub, opposite and conditional subtract at 12 and 17
    words, on the field's edges and draws."""
    p, n = FIELDS[field]
    vals = _edges(field) + _random(field, 6, 3)
    for a in vals:
        assert value(neg_mod(words(a, n), p)) == (-a) % p
        for b in vals:
            assert value(add_mod(words(a, n), words(b, n), p)) == (a + b) % p
            assert value(sub_mod(words(a, n), words(b, n), p)) == (a - b) % p
    for a in vals + [p + v for v in vals if p + v < 1 << (32 * n)]:
        assert value(cond_sub(words(a, n), 0, p)) == (a - p if a >= p else a)


@pytest.mark.parametrize("field", ["p384", "p521"])
def test_inversion_chain(field):
    """field_p384.cuh / field_p521.cuh fe_inv: the addition chain, run with
    the modelled multiply and squaring, is a^(p - 2) (0 maps to 0)."""
    p, _ = FIELDS[field]

    def sqr_n(x, k):
        for _ in range(k):
            x = fe_sqr(field, x)
        return x

    def mul(x, y):
        return fe_mul(field, x, y)

    for a in (0, 1, p - 1, _random(field, 1, 4)[0]):
        x2 = mul(sqr_n(a, 1), a)
        x3 = mul(sqr_n(x2, 1), a)
        if field == "p384":
            x6 = mul(sqr_n(x3, 3), x3)
            x12 = mul(sqr_n(x6, 6), x6)
            x15 = mul(sqr_n(x12, 3), x3)
            x30 = mul(sqr_n(x15, 15), x15)
            x32 = mul(sqr_n(x30, 2), x2)
            x60 = mul(sqr_n(x30, 30), x30)
            x120 = mul(sqr_n(x60, 60), x60)
            x240 = mul(sqr_n(x120, 120), x120)
            x255 = mul(sqr_n(x240, 15), x15)
            t = mul(sqr_n(x255, 33), x32)
            t = mul(sqr_n(t, 94), x30)
            got = mul(sqr_n(t, 2), a)
        else:
            x4 = mul(sqr_n(x2, 2), x2)
            x7 = mul(sqr_n(x4, 3), x3)
            x = mul(sqr_n(x4, 4), x4)
            k = 8
            while k < 512:
                x = mul(sqr_n(x, k), x)
                k *= 2
            x = mul(sqr_n(x, 7), x7)
            got = mul(sqr_n(x, 2), a)
        assert got == pow(a, p - 2, p)
