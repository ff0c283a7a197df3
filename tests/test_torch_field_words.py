"""Word-level models of the CUDA field layer's carry-chain arithmetic
(ecsimd_tpu_torch/csrc/mul256.cuh, limbs.cuh, field_p256.cuh,
field_secp256k1.cuh, field_w25519.cuh), instruction for instruction, on
Python ints.

The kernels run only on the card, so these models are the check of the
algorithms before any card time: each PTX instruction the headers issue
(add.cc / addc / sub.cc / subc, mad.lo / mad.hi with and without the
carry flag, mul.lo)
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

    def madc_lo_cc(self, a, b, c):
        return self.addc_cc((self._word(a) * self._word(b)) & M32, c)

    def mad_hi_cc(self, a, b, c):
        return self.add_cc((self._word(a) * self._word(b)) >> 32, c)

    def madc_hi(self, a, b, c):
        return self.addc((self._word(a) * self._word(b)) >> 32, c)

    @staticmethod
    def mul_lo(a, b):
        return (Ptx._word(a) * Ptx._word(b)) & M32


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


# -- 2^255 - 19: the product's reduction and the lazy arithmetic ----------------

W_LAZY_BOUND = (1 << 255) + 1463  # fe_reduce_lazy: 2^255 + 19 (2 * 38 + 1)


def w_fold19(t, t8):
    """field_w25519.cuh:fe_fold19 — t[0..7] + t8 2^256 -> (t mod 2^255) +
    19 (t >> 255): the bits from 255 up by one funnel shift (shf.l), then
    one add chain that folds them in at 19 (mad.lo.cc, addc.cc ..., addc)
    onto the words with bit 255 cleared."""
    top = ((t8 << 1) | (t[7] >> 31)) & M32  # __funnelshift_l(t7, t8, 1)
    x = Ptx()
    r = [x.mad_lo_cc(top, 19, t[0])] + [x.addc_cc(t[j], 0) for j in range(1, 7)]
    return r + [x.addc(t[7] & 0x7FFFFFFF, 0)]


def w_reduce_lazy(c):
    """field_w25519.cuh:fe_reduce_lazy — any 512-bit c[0..15]: t = lo + 38
    hi, the products' low words on one chain (mad.lo.cc, madc.lo.cc ...,
    addc into the top word), their high words one word up on the next
    (mad.hi.cc, madc.hi.cc ..., madc.hi), top word <= 38; then w_fold19."""
    x = Ptx()
    t = [x.mad_lo_cc(c[8], 38, c[0])] + [x.madc_lo_cc(c[8 + j], 38, c[j]) for j in range(1, 8)]
    t8 = x.addc(0, 0)
    x = Ptx()
    t[1] = x.mad_hi_cc(c[8], 38, t[1])
    for j in range(2, 8):
        t[j] = x.madc_hi_cc(c[7 + j], 38, t[j])
    t8 = x.madc_hi(c[15], 38, t8)
    assert t8 <= 38
    return w_fold19(t, t8)


def w_mul_small_lazy(a, k):
    """field_w25519.cuh:fe_mul_small_lazy — k a for k < 2^26: the 8
    products' low words (mul.lo), their high words one word up (mad.hi.cc,
    madc.hi.cc ..., madc.hi into the top word, below k), then w_fold19."""
    t = [Ptx.mul_lo(aj, k) for aj in a]
    x = Ptx()
    t[1] = x.mad_hi_cc(a[0], k, t[1])
    for j in range(2, 8):
        t[j] = x.madc_hi_cc(a[j - 1], k, t[j])
    t8 = x.madc_hi(a[7], k, 0)
    assert t8 < k
    return w_fold19(t, t8)


def w_add_lazy(a, b):
    """field_w25519.cuh:fe_add_lazy — the 8-word add, then its carry out
    times 38 (the mask -carry & 38) added back on a second chain, whose
    carry out adds 38 once more to the low word (add.u32: no carry, the
    value then being below 38)."""
    x = Ptx()
    r = [x.add_cc(a[0], b[0])] + [x.addc_cc(a[j], b[j]) for j in range(1, 8)]
    m = (0 - x.addc(0, 0)) & M32 & 38
    r = [x.add_cc(r[0], m)] + [x.addc_cc(r[j], 0) for j in range(1, 8)]
    m = (0 - x.addc(0, 0)) & M32 & 38
    assert r[0] + m <= M32
    return [r[0] + m] + r[1:]


def w_sub_lazy(a, b):
    """field_w25519.cuh:fe_sub_lazy — the 8-word subtract, its borrow mask
    (subc 0, 0) & 38 subtracted on a second chain, whose borrow mask & 38
    comes off the low word (sub.u32: no borrow, the value then being at
    least 2^256 - 38)."""
    x = Ptx()
    r = [x.sub_cc(a[0], b[0])] + [x.subc_cc(a[j], b[j]) for j in range(1, 8)]
    m = x.subc(0, 0) & 38
    r = [x.sub_cc(r[0], m)] + [x.subc_cc(r[j], 0) for j in range(1, 8)]
    m = x.subc(0, 0) & 38
    assert r[0] >= m
    return [r[0] - m] + r[1:]


def w_canonical(a):
    """field_w25519.cuh:fe_canonical — w_fold19 with no top word (below
    2^255 + 19 < 2p), then one conditional subtract."""
    r = w_fold19(a, 0)
    assert value(r) < (1 << 255) + 19
    return cond_sub(r, 0, W_P)


def w_mul_lazy(a, b):
    """fe_mul_lazy / fe_sqr_lazy: mul256.cuh's 512-bit product (its words,
    held to a * b by the mul_wide / sqr_wide tests: taken as an int here),
    then w_reduce_lazy."""
    return w_reduce_lazy(words(value(a) * value(b), 16))


def w_ladder_lazy(k, u, a24=121665, nbits=255):
    """csrc/mladder.cu's kernel G for one lane: clamped scalar ``k`` and u <
    p as ints. The scalar's digit w (bits 16 w .. 16 w + 15) is read once
    per 16 steps, shifted so that the next bit is bit 31 (the top digit's
    bit 15, bit 255, not scanned); each step swaps (x2, z2) and (x3, z3)
    by masks on swap ^ k_t, then the RFC 7748 step on the lazy arithmetic;
    after the final swap x2 and z2 are made canonical. Returns (x2, z2) as
    ints; asserts every product below 2^255 + 1463."""

    def mul(a, b):
        r = w_mul_lazy(a, b)
        assert value(r) < W_LAZY_BOUND
        return r

    def swap_if(m, a, b):
        mask = (0 - m) & M32
        t = [(x ^ y) & mask for x, y in zip(a, b)]
        return [x ^ s for x, s in zip(a, t)], [y ^ s for y, s in zip(b, t)]

    uw = words(u)
    x2, z2, x3, z3 = words(1), words(0), uw, words(1)
    swap = 0
    for w in range(15, -1, -1):
        bits = nbits - 16 * 15 if w == 15 else 16
        kw = (((k >> (16 * w)) & 0xFFFF) << (32 - bits)) & M32
        for _ in range(bits):
            kt, kw = kw >> 31, (kw << 1) & M32
            sw = swap ^ kt
            x2, x3 = swap_if(sw, x2, x3)
            z2, z3 = swap_if(sw, z2, z3)
            a = w_add_lazy(x2, z2)
            aa = mul(a, a)
            b = w_sub_lazy(x2, z2)
            bb = mul(b, b)
            e = w_sub_lazy(aa, bb)
            c = w_add_lazy(x3, z3)
            d = w_sub_lazy(x3, z3)
            da, cb = mul(d, a), mul(c, b)
            s = w_add_lazy(da, cb)
            x3 = mul(s, s)
            s = w_sub_lazy(da, cb)
            z3 = mul(uw, mul(s, s))
            x2 = mul(aa, bb)
            z2 = mul(e, w_add_lazy(aa, w_mul_small_lazy(e, a24)))
            swap = kt
    x2, x3 = swap_if(swap, x2, x3)
    z2, z3 = swap_if(swap, z2, z3)
    return value(w_canonical(x2)), value(w_canonical(z2))


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


W_EDGE = [0, 1, 2, 19, 37, 38, W_P - 1, W_P, W_P + 1, 2 * W_P, (1 << 255) - 19, (1 << 255) - 1,
          1 << 255, (1 << 255) + 19, ALL_ONES - 37, ALL_ONES - 1, ALL_ONES]


@pytest.mark.parametrize("a", W_EDGE, ids=hex)
def test_w25519_lazy_edges(a):
    """field_w25519.cuh's lazy add, subtract, product, squaring, small
    multiply and canonicalisation on any 256-bit words, at the edges: 0, 1,
    p - 1, p, 2p, 2^255 +- 19, 2^256 - 1, and the second fold of each add
    (a + b >= 2^257 - 38) and subtract (b - a > 2^256 - 38: a borrow below
    38). Every result is a 256-bit value congruent to the ints' result;
    products below 2^255 + 1463; the canonical ones equal x mod p."""
    aw = words(a)
    assert value(w_canonical(aw)) == a % W_P
    sq = w_mul_lazy(aw, aw)
    assert value(sq) % W_P == a * a % W_P and value(sq) < W_LAZY_BOUND
    sm = w_mul_small_lazy(aw, 121665)
    assert value(sm) % W_P == 121665 * a % W_P and value(sm) < (1 << 255) + (1 << 32)
    for b in W_EDGE:
        bw = words(b)
        r = w_mul_lazy(aw, bw)
        assert value(r) % W_P == a * b % W_P and value(r) < W_LAZY_BOUND
        assert value(w_add_lazy(aw, bw)) % W_P == (a + b) % W_P
        assert value(w_sub_lazy(aw, bw)) % W_P == (a - b) % W_P
        assert value(cond_sub(w_reduce_lazy(mul_wide(aw, bw)), 0, W_P)) == a * b % W_P


def test_w25519_second_folds_are_taken():
    """The inputs that take each lazy fold's second round: a carry out of
    the add's first fold (the low words above 2^256 - 38) and a borrow out
    of the subtract's (a - b + 2^256 below 38)."""
    top = ALL_ONES
    for a, b in ((top, top), (top, top - 36), (top - 18, top - 18)):
        r = value(w_add_lazy(words(a), words(b)))
        assert r == a + b - 2 * (1 << 256) + 2 * 38 and r % W_P == (a + b) % W_P
    for a, b in ((0, top), (5, top - 1), (36, top)):
        r = value(w_sub_lazy(words(a), words(b)))
        assert r == a - b + 2 * (1 << 256) - 2 * 38 and r % W_P == (a - b) % W_P


@pytest.mark.parametrize("c", [0, (1 << 512) - 1, (W_P - 1) ** 2, ALL_ONES ** 2,
                               ((1 << 256) - 1) << 256, (1 << 511) + (1 << 255)],
                         ids=["zero", "all-ones", "(p-1)^2", "(2^256-1)^2", "hi all ones",
                              "bits 511 and 255"])
def test_w25519_reduce_extreme_words(c):
    """The reduction takes any 512-bit c: its top word reaches 38 and the
    fold's top bits 77, and the result stays below 2^255 + 1463."""
    r = value(w_reduce_lazy(words(c, 16)))
    assert r % W_P == c % W_P and r < W_LAZY_BOUND


@settings(max_examples=40, deadline=None)
@given(st.integers(0, ALL_ONES), st.integers(0, ALL_ONES))
def test_w25519_lazy_random(a, b):
    aw, bw = words(a), words(b)
    assert value(w_reduce_lazy(mul_wide(aw, bw))) % W_P == a * b % W_P
    assert value(w_reduce_lazy(sqr_wide(aw))) % W_P == a * a % W_P
    assert value(w_add_lazy(aw, bw)) % W_P == (a + b) % W_P
    assert value(w_sub_lazy(aw, bw)) % W_P == (a - b) % W_P
    assert value(w_canonical(aw)) == a % W_P


def _run_asm(template, ops):
    """One asm statement's PTX text on Python ints: add / sub (with .cc and
    the c forms), mad / mul (.lo, .hi, with .cc and the c forms) and and,
    on .u32 words, keeping the carry flag; %k is operand k, other names
    the statement's own .reg registers."""
    ops, regs, cf = list(ops), {}, 0

    def val(tok):
        return ops[int(tok[1:])] if tok.startswith("%") else regs[tok] if tok in regs else int(
            tok, 0)

    for raw in template.split("\n"):
        line = raw.strip().rstrip(";").strip()
        if line in ("", "{", "}") or line.startswith(".reg"):
            continue
        op, args = line.split(None, 1)
        dst, *src = [a.strip() for a in args.split(",")]
        x = [val(a) for a in src]
        assert all(0 <= v <= M32 for v in x), line
        if op.startswith(("mad", "mul")):
            p = x[0] * x[1]
            s = ((p >> 32) if ".hi" in op else (p & M32)) + (x[2] if op.startswith("mad") else 0)
            s += cf if op.startswith("madc") else 0
        elif op.startswith("add"):
            s = x[0] + x[1] + (cf if op.startswith("addc") else 0)
        elif op.startswith("sub"):
            s = x[0] - x[1] - (cf if op.startswith("subc") else 0)
        else:
            assert op == "and.b32", op
            s = x[0] & x[1]
        if ".cc" in op:
            cf = int(s < 0) if op.startswith("sub") else s >> 32
        if dst.startswith("%"):
            ops[int(dst[1:])] = s & M32
        else:
            regs[dst] = s & M32
    return ops


def test_w25519_asm_text_is_the_model():
    """The asm text of field_w25519.cuh's fe_reduce_lazy, fe_fold19,
    fe_mul_small_lazy, fe_add_lazy and fe_sub_lazy, run instruction by
    instruction on the operands the C++ hands it, gives the models' words
    (so the models above are the text nvcc compiles), on edge and seeded
    random operands."""
    import random

    from tests.test_torch_field_words_wide import _asm_statements, _function

    def text(name):
        (template, _), = _asm_statements(_function("field_w25519.cuh",
                                                   f"__device__ __forceinline__ fe {name}("))
        return template

    red, fold, small, add, sub = (text(n) for n in ("fe_reduce_lazy", "fe_fold19",
                                                    "fe_mul_small_lazy", "fe_add_lazy",
                                                    "fe_sub_lazy"))

    def c_fold(t, t8):
        top = ((t8 << 1) | (t[7] >> 31)) & M32
        return _run_asm(fold, [0] * 8 + [top] + t[:7] + [t[7] & 0x7FFFFFFF])[:8]

    rng = random.Random(7)
    vals = W_EDGE + [rng.getrandbits(256) for _ in range(24)]
    for a in vals:
        aw = words(a)
        t = _run_asm(small, [0] * 9 + aw + [121665])
        assert c_fold(t[:8], t[8]) == w_mul_small_lazy(aw, 121665)
        assert c_fold(aw, 0) == w_fold19(aw, 0)
        for b in vals[::3]:
            bw, c = words(b), words(a * b, 16)
            t = _run_asm(red, [0] * 9 + c)
            assert c_fold(t[:8], t[8]) == w_reduce_lazy(c)
            assert _run_asm(add, [0] * 8 + aw + bw)[:8] == w_add_lazy(aw, bw)
            assert _run_asm(sub, [0] * 8 + aw + bw)[:8] == w_sub_lazy(aw, bw)
