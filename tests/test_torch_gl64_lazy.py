"""The lazy field steps of the CUDA Poseidon core, modelled in python ints.

csrc/gl64.cuh and csrc/poseidon.cuh carry values between rounds that may lie
in [p, 2^64); random data reaches them only ~2^-32 of the time, so the
card's random checks rarely do. Each function below transcribes one step of
the .cuh line for line: the PTX carry chains on 32-bit words with their
carries and borrows, and the FP64 MDS in exact integers. It asserts every
bound that the .cuh's comments claim (no wrap where the chain drops a carry,
every DFMA's sum in [2^52, 2^53), where a double holds each integer
exactly). The tests feed every pair of edge values and
seeded random u64 values and compare with exact integers mod p, and run the
whole lazy permutation against the reference's host permutation.
"""

import itertools

import numpy as np
import pytest

from city_rollup_tpu.core import poseidon_host as ref_host
from city_rollup_tpu_torch.core import poseidon_params as params

P = 0xFFFF_FFFF_0000_0001
EPS = 0xFFFF_FFFF
M64 = (1 << 64) - 1
EDGE = [0, 1, P - 1, P, P + 1, (1 << 64) - (1 << 32), M64, (1 << 32) - 1,
        1 << 32, (1 << 32) + 1]
RNG = np.random.default_rng(1234)
RANDOM = [int(v) for v in RNG.integers(0, 1 << 64, size=12, dtype=np.uint64)]
ANY = EDGE + RANDOM                       # any u64
CANONICAL = [v for v in ANY if v < P]     # the constants' range


# --- gl64.cuh: PTX carry chains on 32-bit words ----------------------------
# add.cc / addc / sub.cc / subc are modelled by the helpers below; the carry
# flag is returned and passed on explicitly.

M32 = (1 << 32) - 1


def _add_cc(a, b, cf=0):
    """add.cc / addc.cc: (sum mod 2^32, carry out)."""
    t = a + b + cf
    return t & M32, t >> 32


def _sub_cc(a, b, bf=0):
    """sub.cc / subc.cc: (difference mod 2^32, borrow out)."""
    t = a - b - bf
    return t & M32, int(t < 0)


def _words(x):
    return x & M32, x >> 32


def _k_eps(w0, w1, k):
    """W + k EPS with k EPS as (-k) + (k >> 31) 2^32 (neg, shr, add.cc,
    addc), asserting that it does not wrap."""
    assert k in (-1, 0, 1)
    w = w0 | (w1 << 32)
    if k == 1:
        assert w + EPS <= M64
    if k == -1:
        assert w >= EPS
    m, h = (-k) & M32, (k >> 31) & M32
    w0, c = _add_cc(w0, m)
    w1, _ = _add_cc(w1, h, c)
    return w0 | (w1 << 32)


def canonicalize(a):
    return a - P if a >= P else a


def add_lazy(a, c):
    assert c < P
    a0, a1 = _words(a)
    c0, c1 = _words(c)
    s0, cf = _add_cc(a0, c0)
    s1, cf = _add_cc(a1, c1, cf)
    k = cf                                  # addc.u32 k, 0, 0
    if k:
        assert (s0 | (s1 << 32)) + EPS <= M64
    s0, bf = _sub_cc(s0, k)
    s1, _ = _sub_cc(s1, 0, bf)
    s1 = (s1 + k) & M32
    return s0 | (s1 << 32)


def mul_words(a, b):
    a0, a1 = _words(a)
    b0, b1 = _words(b)
    r0, r1 = _words(a0 * b0)
    r2, r3 = _words(a1 * b1)
    for m, h in (_words(a0 * b1), _words(a1 * b0)):
        r1, cf = _add_cc(r1, m)
        r2, cf = _add_cc(r2, h, cf)
        r3, cf = _add_cc(r3, 0, cf)
        assert cf == 0
    return r0, r1, r2, r3


def reduce_words(r0, r1, r2, r3):
    s, cf = _add_cc(r2, r3)
    sh = cf
    w0, bf = _sub_cc(r0, s)
    w1, bf = _sub_cc(r1, sh, bf)
    k = -bf                                 # subc.u32 k, 0, 0
    w1, cf = _add_cc(w1, r2)
    k += cf
    return _k_eps(w0, w1, k)


def reduce_split_lazy(lo, hi):
    assert lo < 1 << 42 and hi < 1 << 42
    a0, a1 = _words(lo)
    b0, b1 = _words(hi)
    s, cf = _add_cc(a1, b0)
    sh = cf
    s, cf = _add_cc(s, b1)
    sh += cf
    w0, bf = _sub_cc(a0, b1)
    w1, bf = _sub_cc(s, 0, bf)
    k = sh - bf
    return _k_eps(w0, w1, k)


def mul_lazy(a, b):
    return reduce_words(*mul_words(a, b))


# --- poseidon.cuh -----------------------------------------------------------

W = params.WIDTH
CIRC, DIAG = params.MDS_MATRIX_CIRC, params.MDS_MATRIX_DIAG


def sbox(x):
    x2 = mul_lazy(x, x)
    x3 = mul_lazy(x2, x)
    x6 = mul_lazy(x3, x3)
    return mul_lazy(x6, x)


TWO52 = 1 << 52
RC_NEXT = params.ALL_ROUND_CONSTANTS + [0] * W    # row 30: no constants


def word_f64(h):
    """pos_word_f64: (2^52 + h) - 2^52, exact for a 32-bit word."""
    assert 0 <= h <= M32
    return h


def dfma(c, x, acc):
    """fma(c, x, acc) on doubles that hold integers: exact while the
    accumulator stays in [2^52, 2^53), where a double's step is 1."""
    out = c * x + acc
    assert TWO52 <= acc and out < 1 << 53
    return out


def mds(s, r_next):
    """pos_mds: MDS s + round r_next's constants, the sums on doubles."""
    lo = [word_f64(v & M32) for v in s]
    hi = [word_f64(v >> 32) for v in s]
    out = []
    for r in range(W):
        c_next = RC_NEXT[r_next * W + r]
        acc_lo, acc_hi = TWO52 + (c_next & M32), TWO52 + (c_next >> 32)
        for i in range(W):
            c = CIRC[i] + (DIAG[r] if i == 0 else 0)
            acc_lo = dfma(c, lo[(i + r) % W], acc_lo)
            acc_hi = dfma(c, hi[(i + r) % W], acc_hi)
        # the bits of a double in [2^52, 2^53) below bit 52: value - 2^52
        out.append(reduce_split_lazy(acc_lo & (TWO52 - 1),
                                     acc_hi & (TWO52 - 1)))
    return out


def full_round(s, r):
    return mds([sbox(v) for v in s], r + 1)


def partial_round(s, r):
    return mds([sbox(s[0])] + s[1:], r + 1)


def permute(s):
    rc = params.ALL_ROUND_CONSTANTS
    s = [add_lazy(v, rc[i]) for i, v in enumerate(s)]
    h, n = params.HALF_N_FULL_ROUNDS, params.N_PARTIAL_ROUNDS
    for r in range(h):
        s = full_round(s, r)
    for r in range(h, h + n):
        s = partial_round(s, r)
    for r in range(h + n, params.N_ROUNDS):
        s = full_round(s, r)
    return [canonicalize(v) for v in s]


# --- tests ------------------------------------------------------------------

def _u64(v):
    assert 0 <= v <= M64
    return v


def test_add_lazy_on_edge_pairs():
    for a, c in itertools.product(ANY, CANONICAL):
        assert _u64(add_lazy(a, c)) % P == (a + c) % P


def test_mul_words_and_mul_lazy_on_edge_pairs():
    for a, b in itertools.product(ANY, ANY):
        r0, r1, r2, r3 = mul_words(a, b)
        assert r0 + (r1 << 32) + (r2 << 64) + (r3 << 96) == a * b
        assert _u64(mul_lazy(a, b)) % P == a * b % P


def test_reduce_words_on_edge_pairs():
    for lo, hi in itertools.product(ANY, ANY):
        got = reduce_words(*_words(lo), *_words(hi))
        assert _u64(got) % P == (lo + (hi << 64)) % P


def test_reduce_split_lazy_on_edge_pairs():
    """The MDS's split accumulators, both < 2^41 (264 (2^32 - 1))."""
    big = 264 * M32
    vals = [0, 1, M32, 1 << 32, (1 << 32) + 1, big - 1, big] + \
        [int(v) for v in RNG.integers(0, big, size=8, dtype=np.uint64)]
    for lo, hi in itertools.product(vals, vals):
        assert _u64(reduce_split_lazy(lo, hi)) % P == (lo + (hi << 32)) % P


def test_canonicalize_any_u64():
    for a in ANY:
        assert canonicalize(a) == a % P


def _states():
    """12-lane states: every pair (a, b) of values laid out alternately,
    plus seeded random states of any u64."""
    for a, b in itertools.product(ANY, ANY):
        yield [a, b] * (W // 2)
    rng = np.random.default_rng(99)
    for _ in range(32):
        yield [int(v) for v in rng.integers(0, 1 << 64, size=W,
                                            dtype=np.uint64)]


@pytest.mark.parametrize("r_next", [1, 17, 30])
def test_fp64_mds_on_edge_states(r_next):
    """The FP64 MDS plus the next round's constants, on states of every
    pair of edge values (any u64) and seeded random states."""
    for s in _states():
        got = mds(s, r_next)
        for r in range(W):
            want = RC_NEXT[r_next * W + r] + sum(
                (CIRC[i] + (DIAG[r] if i == 0 else 0)) * s[(i + r) % W]
                for i in range(W))
            assert _u64(got[r]) % P == want % P


@pytest.mark.parametrize("kind", ["edge", "random"])
def test_lazy_permutation_matches_reference(kind):
    """The whole lazy core (full rounds, fast partial rounds, the single
    canonicalisation) equals the reference's host permutation."""
    rng = np.random.default_rng(5)
    if kind == "edge":
        canon = [v for v in EDGE if v < P]
        states = [[v] * W for v in canon]
        states += [list(rng.choice(canon, size=W)) for _ in range(6)]
        states = [[int(v) for v in s] for s in states]
    else:
        states = [[int(v) for v in rng.integers(0, P, size=W,
                                                dtype=np.uint64)]
                  for _ in range(6)]
    for s in states:
        assert permute(s) == ref_host.permute(s)
