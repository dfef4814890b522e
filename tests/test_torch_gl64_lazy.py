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


def sub_lazy(a, c):
    """gl_sub_lazy: a - c for any u64 a and c < p."""
    assert c < P
    a0, a1 = _words(a)
    c0, c1 = _words(c)
    d0, bf = _sub_cc(a0, c0)
    d1, bf = _sub_cc(a1, c1, bf)
    k = (-bf) & M32                         # subc.u32 k, 0, 0
    if bf:
        assert (d0 | (d1 << 32)) > EPS      # d - EPS does not wrap
    d0, bf = _sub_cc(d0, k)
    d1, bf = _sub_cc(d1, 0, bf)
    assert bf == 0
    return d0 | (d1 << 32)


def mul_pow2_lazy(x, e):
    """gl_mul_pow2_lazy: x * 2^e for 0 < e < 64, the shifted words of x
    reduced once."""
    assert 0 < e < 64
    lo, hi = (x << e) & M64, x >> (64 - e)
    return reduce_words(*_words(lo), *_words(hi))


def pow2_const(e):
    """gl_pow2_const: 2^e mod p for 0 <= e < 96."""
    return (1 << e) if e < 64 else (1 << (e - 32)) - (1 << (e - 64))


# --- ntt.cu ------------------------------------------------------------------

W16_LOG2 = 156


def butterfly(a, b, e, shift=True, lazy=True):
    """ntt.cu's butterfly: (a + w b, a - w b) for w = 2^e mod p; 2^96 = -1
    swaps the outputs. a and b any u64 when lazy, canonical otherwise."""
    e %= 192
    neg, f = e >= 96, e % 96
    if f == 0:
        t = b
    elif shift and f < 64:
        t = mul_pow2_lazy(b, f)
    else:
        t = mul_lazy(b, pow2_const(f))
    t = canonicalize(t)
    if lazy:
        s, d = add_lazy(a, t), sub_lazy(a, t)
    else:
        assert a < P
        s, d = canonicalize(add_lazy(a, t)), (a - t) % (1 << 64)
        if a < t:
            d -= EPS
    return (d, s) if neg else (s, d)


def _brev(x, bits):
    return int(format(x, f"0{bits}b")[::-1], 2) if bits else 0


def dft_regs(v, rl, **kw):
    """ntt.cu's dft_regs: radix-2 DIT over the bit-reversed view of v, the
    twiddles of stage s powers of w_16 = 2^156; X[k] is left in v[brev(k)]."""
    v = list(v)
    for s in range(rl):
        h = 1 << s
        for i in range((1 << rl) // 2):
            j = i & (h - 1)
            i0 = ((i >> s) << (s + 1)) | j
            a, b = _brev(i0, rl), _brev(i0 + h, rl)
            v[a], v[b] = butterfly(v[a], v[b], W16_LOG2 * j * (8 >> s), **kw)
    return [v[_brev(k, rl)] for k in range(1 << rl)]


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


def test_sub_lazy_on_edge_pairs():
    for a, c in itertools.product(ANY, CANONICAL):
        assert _u64(sub_lazy(a, c)) % P == (a - c) % P


def test_mul_pow2_lazy_on_edge_values():
    for x, e in itertools.product(ANY, range(1, 64)):
        assert _u64(mul_pow2_lazy(x, e)) % P == (x << e) % P
    for e in range(96):
        assert pow2_const(e) == pow(2, e, P) and pow2_const(e) < P


def test_w16_is_a_power_of_two():
    """Every 16th root of unity of the reference is a power of 2."""
    from city_rollup_tpu.core import gl64 as jg
    assert pow(2, W16_LOG2, P) == jg.h_primitive_root_of_unity(4)
    assert pow(2, 96, P) == P - 1


@pytest.mark.parametrize("shift,lazy", [(True, True), (False, True),
                                        (True, False)])
def test_butterfly_on_edge_pairs(shift, lazy):
    """Every twiddle exponent a radix-16 DFT uses, on every pair of edge
    values (any u64 for the lazy butterfly, canonical otherwise)."""
    vals = ANY if lazy else CANONICAL
    exps = {(W16_LOG2 * j * (8 >> s)) % 192 for s in range(4)
            for j in range(1 << s)}
    for e in exps:
        w = pow(2, e, P)
        for a, b in itertools.product(vals, vals):
            s_, d = butterfly(a, b, e, shift=shift, lazy=lazy)
            assert _u64(s_) % P == (a + w * b) % P
            assert _u64(d) % P == (a - w * b) % P
            if not lazy:
                assert s_ < P and d < P


@pytest.mark.parametrize("rl", [1, 2, 3, 4])
def test_dft_regs_is_the_dft(rl):
    """The in-register radix-2^rl DFT equals sum_a x[a] w^(a k), w the
    reference's 2^rl-th root, on edge and random lazy inputs."""
    from city_rollup_tpu.core import gl64 as jg
    r = 1 << rl
    w = jg.h_primitive_root_of_unity(rl)
    rng = np.random.default_rng(rl)
    inputs = [[EDGE[(i + k) % len(EDGE)] for i in range(r)]
              for k in range(len(EDGE))]
    inputs += [[int(v) for v in rng.integers(0, 1 << 64, size=r,
                                             dtype=np.uint64)]
               for _ in range(8)]
    for x in inputs:
        got = dft_regs(x, rl)
        want = [sum(x[a] * pow(w, a * k, P) for a in range(r)) % P
                for k in range(r)]
        assert [_u64(g) % P for g in got] == want


def _mutant(fn, mutate):
    """Run fn with one helper of this model replaced."""
    saved = {k: globals()[k] for k in mutate}
    globals().update(mutate)
    try:
        return fn()
    except AssertionError:
        return "assertion"
    finally:
        globals().update(saved)


@pytest.mark.parametrize("name", ["no_borrow_fix", "dropped_hi_word",
                                  "unswapped_sign"])
def test_ntt_model_mutations_fail(name):
    """A mutated model (a dropped borrow correction, a dropped high word of
    the shifted product, a sign of 2^96 ignored) fails the checks above."""
    def no_borrow_fix(a, c):
        return (a - c) % (1 << 64)

    def dropped_hi_word(x, e):
        lo = (x << e) & M64
        return reduce_words(*_words(lo), 0, 0)

    def unswapped_sign(a, b, e, shift=True, lazy=True):
        t = canonicalize(mul_lazy(b, pow(2, e % 96, P)))
        return add_lazy(a, t), sub_lazy(a, t)

    mutate = {"no_borrow_fix": {"sub_lazy": no_borrow_fix},
              "dropped_hi_word": {"mul_pow2_lazy": dropped_hi_word},
              "unswapped_sign": {"butterfly": unswapped_sign}}[name]
    outcome = _mutant(lambda: test_dft_regs_is_the_dft(4), mutate)
    assert outcome == "assertion"
