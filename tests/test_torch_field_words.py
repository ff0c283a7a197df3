"""Word-level models of the CUDA field layer's carry-chain arithmetic
(ecsimd_tpu_torch/csrc/mul256.cuh, limbs.cuh, field_p256.cuh,
field_secp256k1.cuh), instruction for instruction, on Python ints.

The kernels run only on the card, so these models are the check of the
algorithms before any card time: each PTX instruction the headers issue
(add.cc / addc / sub.cc / subc, mad.lo.cc / madc.hi.cc)
is a method of ``Ptx`` below that keeps the carry flag and asserts that
every word it writes is a 32-bit word. The models are held to ``pow``-free
modular arithmetic on ints and to the port's Montgomery oracle
(oracle/field.mont_mul) on edge inputs and hypothesis draws. Tolerance:
exact.
"""

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from ecsimd_tpu_torch.oracle import field as ofield
from ecsimd_tpu_torch.specs import P256, SECP256K1, W25519_FIELD

M32 = 0xFFFFFFFF
P256_P = P256.field.p
K1_P = SECP256K1.field.p
W_P = W25519_FIELD.p
K1_MPRIME = 0xD2253531  # -p^-1 mod 2^32, csrc/field_secp256k1.cuh


class Ptx:
    """The PTX integer instructions of the field headers, with the carry
    flag CC.CF that add.cc / sub.cc / mad*.cc write and addc / subc / madc
    read. sub.cc and subc set CF on a borrow, as PTX does."""

    def __init__(self):
        self.cf = 0

    @staticmethod
    def _word(x):
        assert 0 <= x <= M32, hex(x)
        return x

    def add_cc(self, a, b):
        s = self._word(a) + self._word(b)
        self.cf = s >> 32
        return s & M32

    def addc_cc(self, a, b):
        s = self._word(a) + self._word(b) + self.cf
        self.cf = s >> 32
        return s & M32

    def addc(self, a, b):
        return (self._word(a) + self._word(b) + self.cf) & M32

    def sub_cc(self, a, b):
        d = self._word(a) - self._word(b)
        self.cf = int(d < 0)
        return d & M32

    def subc_cc(self, a, b):
        d = self._word(a) - self._word(b) - self.cf
        self.cf = int(d < 0)
        return d & M32

    def subc(self, a, b):
        return (self._word(a) - self._word(b) - self.cf) & M32

    def mad_lo_cc(self, a, b, c):
        return self.add_cc((self._word(a) * self._word(b)) & M32, c)

    def madc_hi_cc(self, a, b, c):
        return self.addc_cc((self._word(a) * self._word(b)) >> 32, c)


def words(x, n=8):
    assert 0 <= x < 1 << (32 * n)
    return [(x >> (32 * i)) & M32 for i in range(n)]


def value(ws):
    return sum(w << (32 * i) for i, w in enumerate(ws))


def mac(acc, a, b):
    """mul256.cuh:mac — one product into the three-word column
    accumulator (c0, c1, c2): mad.lo.cc, madc.hi.cc, addc."""
    x = Ptx()
    c0 = x.mad_lo_cc(a, b, acc[0])
    c1 = x.madc_hi_cc(a, b, acc[1])
    c2 = x.addc(acc[2], 0)
    return [c0, c1, c2]


def mul_wide(a, b):
    """mul256.cuh:mul_wide — the product-scanning (Comba) 256 x 256 -> 512
    product: column k sums a_i b_j over i + j = k into (c0, c1, c2), writes
    c0 and shifts the accumulator down one word."""
    out, acc = [], [0, 0, 0]
    for k in range(15):
        for i in range(max(0, k - 7), min(7, k) + 1):
            acc = mac(acc, a[i], b[k - i])
        out.append(acc[0])
        acc = [acc[1], acc[2], 0]
    assert acc[1] == 0
    return out + [acc[0]]


def sqr_wide(a):
    """mul256.cuh:sqr_wide — the dedicated squaring: the 28 cross products
    a_i a_j (i < j) by columns into the three-word accumulator, then one
    chain that doubles the 16 column words and two add chains that add the
    8 squares a_i^2 (one wide product each) at words 2i, 2i + 1: 36
    products."""
    tri, acc = [0], [0, 0, 0]
    for k in range(1, 14):
        for i in range(max(0, k - 7), (k + 1) // 2):
            acc = mac(acc, a[i], a[k - i])
        tri.append(acc[0])
        acc = [acc[1], acc[2], 0]
    assert acc[1] < 1 << 31  # the triangle is below 2^511
    tri += acc[:2]
    x = Ptx()
    dbl = [0] + [x.add_cc(tri[1], tri[1])] + [x.addc_cc(t, t) for t in tri[2:15]]
    dbl.append(x.addc(tri[15], tri[15]))
    # the squares a_i^2 at words 2i, 2i + 1, added in two chains: words 0 .. 8
    # with the carry out in cy, then cy joins a_4^2's high word (at most
    # 2^32 - 2 + 1) for words 9 .. 15
    sq = [w for i in range(8) for w in words(a[i] * a[i], 2)]
    x = Ptx()
    r = [x.add_cc(dbl[0], sq[0])] + [x.addc_cc(dbl[j], sq[j]) for j in range(1, 9)]
    cy = x.addc(0, 0)
    x = Ptx()
    r += [x.add_cc(dbl[9], x._word(sq[9] + cy))] + [
        x.addc_cc(dbl[j], sq[j]) for j in range(10, 15)] + [x.addc(dbl[15], sq[15])]
    return r


def cond_sub(a, carry, p):
    """limbs.cuh:fe_cond_sub — a - p when carry or a >= p, else a
    (canonical when a + carry 2^256 < 2p): one sub chain whose last subc
    gives carry - borrow, whose sign spread over the word is the keep-a
    mask, then a masked select."""
    x = Ptx()
    pw = words(p)
    t = [x.sub_cc(a[0], pw[0])] + [x.subc_cc(a[j], pw[j]) for j in range(1, 8)]
    keep_a = M32 if x.subc(carry, 0) >> 31 else 0
    return [(aj & keep_a) | (tj & ~keep_a & M32) for aj, tj in zip(a, t)]


def add_mod(a, b, p):
    x = Ptx()
    s = [x.add_cc(a[0], b[0])] + [x.addc_cc(a[j], b[j]) for j in range(1, 8)]
    return cond_sub(s, x.addc(0, 0), p)


def sub_mod(a, b, p):
    """a - b, then p & mask added back where it borrowed."""
    x = Ptx()
    d = [x.sub_cc(a[0], b[0])] + [x.subc_cc(a[j], b[j]) for j in range(1, 8)]
    m = x.subc(0, 0)
    pm = [w & m for w in words(p)]
    x = Ptx()
    return [x.add_cc(d[0], pm[0])] + [x.addc_cc(d[j], pm[j]) for j in range(1, 8)]


def neg_mod(a, p):
    """p - a, masked to 0 where a == 0."""
    x = Ptx()
    pw = words(p)
    d = [x.sub_cc(pw[0], a[0])] + [x.subc_cc(pw[j], a[j]) for j in range(1, 8)]
    nz = M32 if any(a) else 0
    return [w & nz for w in d]


# -- P-256: FIPS 186-4 D.2.3 on 32-bit carry chains --------------------------------

P256_5P = words(5 * P256_P - (4 << 256))  # 5p = 4 2^256 + these words


def acc_add(x, t, ws, start=0):
    """t[start..8] += ws (words start..7), the carry into the top word t[8]."""
    t = list(t)
    t[start] = x.add_cc(t[start], ws[0])
    for j, w in enumerate(ws[1:], start + 1):
        t[j] = x.addc_cc(t[j], w)
    t[8] = x.addc(t[8], 0)
    return t


def acc_sub(x, t, ws):
    t = list(t)
    t[0] = x.sub_cc(t[0], ws[0])
    for j in range(1, 8):
        t[j] = x.subc_cc(t[j], ws[j])
    t[8] = x.subc(t[8], 0)
    return t


def p256_reduce(c):
    """field_p256.cuh:fe_reduce — r = s1 + 2 s2 + 2 s3 + s4 + s5 - s6 - s7 -
    s8 - s9 (FIPS 186-4 D.2.3) plus 5p, so that no partial sum is negative,
    in a nine-word accumulator (top word t in [0, 11]); then t 2^256 folds
    as t (2^224 - 2^192 - 2^96 + 1), which leaves a value below 2^256 + 11
    2^224 < 2p, and one conditional subtract."""
    c0, c1, c2, c3, c4, c5, c6, c7, c8, c9, c10, c11, c12, c13, c14, c15 = c
    t = P256_5P + [4]
    t = acc_add(Ptx(), t, [c0, c1, c2, c3, c4, c5, c6, c7])
    for s in ([c11, c12, c13, c14, c15], [c12, c13, c14, c15, 0]):  # s2, s3, twice each
        t = acc_add(Ptx(), t, s, 3)
        t = acc_add(Ptx(), t, s, 3)
    t = acc_add(Ptx(), t, [c8, c9, c10, 0, 0, 0, c14, c15])  # s4
    t = acc_add(Ptx(), t, [c9, c10, c11, c13, c14, c15, c13, c8])  # s5
    for s in ([c11, c12, c13, 0, 0, 0, c8, c10], [c12, c13, c14, c15, 0, 0, c9, c11],
              [c13, c14, c15, c8, c9, c10, 0, c12], [c14, c15, 0, c9, c10, c11, 0, c13]):
        t = acc_sub(Ptx(), t, s)  # s6 .. s9
    top = t[8]
    assert top <= 11
    r = t[:8]
    x = Ptx()
    r[0] = x.add_cc(r[0], top)
    for j in range(1, 7):
        r[j] = x.addc_cc(r[j], 0)
    r[7] = x.addc_cc(r[7], top)
    hi = x.addc(0, 0)
    x = Ptx()
    r[3] = x.sub_cc(r[3], top)
    r[4] = x.subc_cc(r[4], 0)
    r[5] = x.subc_cc(r[5], 0)
    r[6] = x.subc_cc(r[6], top)
    r[7] = x.subc_cc(r[7], 0)
    hi = x.subc(hi, 0)
    assert hi <= 1 and value(r) + (hi << 256) < 2 * P256_P
    return cond_sub(r, hi, P256_P)


# -- secp256k1: the sparse Montgomery reduction, R = 2^256 -----------------------


def k1_redc(t):
    """field_secp256k1.cuh:fe_redc — t (16 words, t < p 2^256) -> t 2^-256
    mod p. p = 2^256 - 2^32 - 977, so m p = m 2^256 - m (2^32 + 977): round
    i takes m = t_i m' (one product), 977 m (one wide product; its low word
    is t_i, so word i cancels with no borrow), and subtracts e = 977 m + m
    2^32 (three words e0 = t_i, e1, e2 <= 1) from words i + 1, i + 2, with
    the borrow out of word i + 2 pending for word i + 3 — one round later.
    After 8 rounds the words 8 .. 15, plus M = (m_0 .. m_7), minus the
    last pending borrow at word 10, are (t + M p) / 2^256 < 2p; one
    conditional subtract."""
    t = list(t)
    ms, pend = [], 0
    for i in range(8):
        m = (t[i] * K1_MPRIME) & M32  # mul.lo.u32
        lo, hi = (977 * m) & M32, (977 * m) >> 32  # mul.lo.u32, mul.hi.u32
        assert lo == t[i]
        x = Ptx()
        e1 = x.add_cc(hi, m)
        e2 = x.addc(pend, 0)  # e2 = carry + pending borrow, <= 2
        x = Ptx()
        t[i + 1] = x.sub_cc(t[i + 1], e1)
        t[i + 2] = x.subc_cc(t[i + 2], e2)
        pend = x.subc(0, 0) & 1  # the borrow out of word i + 2
        t[i] = 0
        ms.append(m)
    x = Ptx()
    r = [x.add_cc(t[8], ms[0])] + [x.addc_cc(t[8 + j], ms[j]) for j in range(1, 8)]
    top = x.addc(0, 0)
    x = Ptx()
    r[2] = x.sub_cc(r[2], pend)
    for j in range(3, 8):
        r[j] = x.subc_cc(r[j], 0)
    top = x.subc(top, 0)
    assert top <= 1 and value(r) + (top << 256) < 2 * K1_P  # t < 2p after 8 rounds
    return cond_sub(r, top, K1_P)


# -- the checks ------------------------------------------------------------------

EDGE = {
    "p256": [0, 1, 2, P256_P - 1, P256_P - 2, P256_P - (1 << 224), (1 << 255) - 1,
             P256_P - 0xFFFFFFFF, (1 << 256) - (1 << 225) - 1],
    "secp256k1": [0, 1, 2, K1_P - 1, K1_P - 2, K1_P - (1 << 32), (1 << 255) - 1,
                  K1_P - 0xFFFFFFFF, (1 << 32) + 977, K1_P - 977],
}
ALL_ONES = (1 << 256) - 1  # every word 0xFFFFFFFF: the grid's largest carries


def _pairs(edges):
    return [(a, b) for a in edges for b in edges]


@pytest.mark.parametrize("a", [0, 1, M32, ALL_ONES, (1 << 255) | 1, 0xFFFFFFFF << 224,
                               ALL_ONES - (1 << 128), 0x8000000080000000 * (1 + (1 << 128))])
def test_mul_and_sqr_wide_edges(a):
    """All-ones words carry the most: each column of the three-word
    accumulator and the doubled triangle stay 32-bit words (Ptx asserts)."""
    for b in (a, ALL_ONES, 1, M32 << 32):
        assert value(mul_wide(words(a), words(b))) == a * b
    assert value(sqr_wide(words(a))) == a * a


@settings(max_examples=300, deadline=None)
@given(st.integers(0, ALL_ONES), st.integers(0, ALL_ONES))
def test_mul_and_sqr_wide_random(a, b):
    assert value(mul_wide(words(a), words(b))) == a * b
    assert value(sqr_wide(words(a))) == a * a


@pytest.mark.parametrize("a,b", _pairs(EDGE["p256"]))
def test_p256_reduce_edges(a, b):
    assert value(p256_reduce(mul_wide(words(a), words(b)))) == a * b % P256_P
    assert value(p256_reduce(sqr_wide(words(a)))) == a * a % P256_P


@pytest.mark.parametrize("c", [0, (1 << 512) - 1, (P256_P - 1) ** 2, P256_P << 256,
                               ((1 << 256) - 1) * P256_P, (1 << 511) + (1 << 256) - 1],
                         ids=["zero", "all-ones", "(p-1)^2", "p 2^256", "p (2^256-1)", "mixed"])
def test_p256_reduce_extreme_words(c):
    """The reduction takes any 512-bit c: the sums' extremes (top word 0 and
    11, every word all ones) stay inside the accumulator and the fold."""
    assert value(p256_reduce(words(c, 16))) == c % P256_P


@settings(max_examples=300, deadline=None)
@given(st.integers(0, P256_P - 1), st.integers(0, P256_P - 1))
def test_p256_reduce_random(a, b):
    assert value(p256_reduce(mul_wide(words(a), words(b)))) == a * b % P256_P
    assert value(p256_reduce(sqr_wide(words(a)))) == a * a % P256_P


def _k1_mont(a, b):
    return value(k1_redc(mul_wide(words(a), words(b))))


@pytest.mark.parametrize("a,b", _pairs(EDGE["secp256k1"]))
def test_k1_redc_edges(a, b):
    fs = SECP256K1.field
    assert _k1_mont(a, b) == ofield.mont_mul(a, b, fs)
    assert value(k1_redc(sqr_wide(words(a)))) == ofield.mont_sqr(a, fs)


@pytest.mark.parametrize("t", [0, 1, (K1_P - 1) ** 2, (K1_P << 256) - 1, K1_P * ((1 << 256) - 1),
                               (1 << 256) - 1, 977 * 0xD2253531],
                         ids=["zero", "one", "(p-1)^2", "p 2^256 - 1", "p (2^256-1)",
                              "2^256 - 1", "977 m'"])
def test_k1_redc_extremes(t):
    """Any t < p 2^256 (the Montgomery precondition), the largest included:
    each round's pending borrow and the 8-round bound t < 2p."""
    fs = SECP256K1.field
    assert value(k1_redc(words(t, 16))) == t * fs.R_inv % K1_P


@settings(max_examples=300, deadline=None)
@given(st.integers(0, K1_P - 1), st.integers(0, K1_P - 1))
def test_k1_redc_random(a, b):
    fs = SECP256K1.field
    assert _k1_mont(a, b) == ofield.mont_mul(a, b, fs)
    assert value(k1_redc(sqr_wide(words(a)))) == ofield.mont_sqr(a, fs)


def test_k1_to_classical_and_one():
    """fe_to_classical is REDC(x 1) and fe_one is R mod p = 2^32 + 977."""
    fs = SECP256K1.field
    for xm in (1, fs.R % K1_P, K1_P - 1, 12345 << 200):
        assert value(k1_redc(mul_wide(words(xm), words(1)))) == xm * fs.R_inv % K1_P
    assert fs.R % K1_P == (1 << 32) + 977


@pytest.mark.parametrize("p", [P256_P, K1_P, W_P], ids=["p256", "secp256k1", "2^255-19"])
def test_modular_add_sub_neg(p):
    """limbs.cuh's add, sub, opposite and conditional subtract on carry
    chains, for the three field primes, on their edges and a spread of
    values."""
    vals = [0, 1, 2, p - 1, p - 2, p >> 1, (p >> 1) + 1, p - (1 << 32), (1 << 255) % p,
            0xFFFFFFFF, p - 0xFFFFFFFF]
    vals += [(0x9E3779B97F4A7C15 ** (i + 3)) % p for i in range(8)]
    for a in vals:
        assert value(neg_mod(words(a), p)) == (-a) % p
        for b in vals:
            assert value(add_mod(words(a), words(b), p)) == (a + b) % p
            assert value(sub_mod(words(a), words(b), p)) == (a - b) % p
    for a in vals + [p + v for v in vals if p + v < 1 << 256]:
        assert value(cond_sub(words(a), 0, p)) == (a - p if a >= p else a)
    # a carry out of the add: a + 2^256 < 2p
    for a in (0, 1, 2 * p - (1 << 256) - 1):
        if a >= 0 and a + (1 << 256) < 2 * p:
            assert value(cond_sub(words(a), 1, p)) == a + (1 << 256) - p
    # outside the domain (a + carry 2^256 >= 2p) it subtracts p once, as the
    # 64-bit ripple it replaced did: a carry with no borrow takes a - p
    for a in (p, (1 << 256) - 1, 2 * p % (1 << 256)):
        assert value(cond_sub(words(a), 1, p)) == (a + (1 << 256) - p) % (1 << 256)
