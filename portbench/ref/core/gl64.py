"""Goldilocks field (p = 2^64 - 2^32 + 1) on ``torch.int64`` tensors.

A value is one int64 element carrying its u64 bit pattern. This CPU build
of PyTorch has no add, shift or compare on ``torch.uint64``, so the plain
versions below do u64 arithmetic on int64, minding three traps:

- int64 multiplication wraps silently: a product of two 32-bit limbs is the
  right u64 bit pattern, and nothing larger is ever multiplied;
- ``>>`` is an arithmetic shift, so every right shift is masked;
- an unsigned compare flips the sign bit on both sides (``_ult``).

These are the plain versions of the arithmetic that ``csrc/gl64.cuh`` does
on native ``uint64_t`` in the kernels. The host helpers (``np_*``, ``h_*``)
are copies of the reference's (``city_rollup_tpu/core/gl64.py``).
"""

from __future__ import annotations

import numpy as np
import torch

# Field constants
P = 0xFFFF_FFFF_0000_0001          # 2^64 - 2^32 + 1
EPSILON = 0xFFFF_FFFF              # 2^32 - 1 == 2^64 mod p
MULTIPLICATIVE_GROUP_GENERATOR = 7
TWO_ADICITY = 32
# 7^((p-1) / 2^32) mod p — generator of the maximal 2-adic subgroup.
POWER_OF_TWO_GENERATOR = 0x185629DCDA58878C

_M32 = 0xFFFF_FFFF
_SIGN = -(1 << 63)                 # int64 bit pattern of 2^63
_P_FLIPPED = P ^ (1 << 63)         # p with its sign bit flipped, for _ult


def to_i64(v: int) -> int:
    """A u64 python int -> the python int with the same int64 bit pattern."""
    v = int(v) % (1 << 64)
    return v - (1 << 64) if v >= 1 << 63 else v


# ---------------------------------------------------------------------------
# u64 helpers on int64 bit patterns
# ---------------------------------------------------------------------------

def _ult(x, y):
    """Unsigned x < y on int64 bit patterns."""
    return (x ^ _SIGN) < (y ^ _SIGN)


def _hi32(x):
    """Logical x >> 32."""
    return (x >> 32) & _M32


# ---------------------------------------------------------------------------
# Field ops (plain versions; inputs canonical unless stated)
# ---------------------------------------------------------------------------

def canonicalize(a):
    """Reduce any u64 (< 2p) into [0, p) by one conditional subtract of p."""
    return torch.where((a ^ _SIGN) < _P_FLIPPED, a, a + EPSILON)


def add(a, b):
    """(a + b) mod p."""
    s = a + b
    # a carry out of bit 64 is worth 2^64 ≡ EPSILON; it cannot carry again
    s = s + _ult(s, a).to(s.dtype) * EPSILON
    return canonicalize(s)


def sub(a, b):
    """(a - b) mod p."""
    d = a - b
    # a borrow took 2^64 too many; adding p back is subtracting EPSILON
    return d - _ult(a, b).to(d.dtype) * EPSILON


def _reduce128(lo, hi):
    """(lo + hi * 2^64) mod p, for u64 bit patterns lo and hi.

    2^64 ≡ 2^32 - 1 and 2^96 ≡ -1, so the value is
    lo - hi_hi + hi_lo * (2^32 - 1), as in the reference's _reduce128."""
    hi_lo = hi & _M32
    hi_hi = _hi32(hi)
    t = lo - hi_hi
    t = t - _ult(lo, hi_hi).to(t.dtype) * EPSILON
    m = hi_lo * EPSILON                # < 2^64: the bit pattern is exact
    r = t + m
    r = r + _ult(r, m).to(r.dtype) * EPSILON
    return canonicalize(r)


def mul(a, b):
    """(a * b) mod p: the 128-bit product from four 32x32 -> 64 partials."""
    a0, a1 = a & _M32, _hi32(a)
    b0, b1 = b & _M32, _hi32(b)
    ll = a0 * b0
    lh = a0 * b1
    hl = a1 * b0
    hh = a1 * b1
    mid = lh + hl
    c_mid = _ult(mid, hl).to(mid.dtype)        # worth 2^96
    lo = ll + (mid << 32)
    c_lo = _ult(lo, ll).to(lo.dtype)
    hi = hh + _hi32(mid) + (c_mid << 32) + c_lo
    return _reduce128(lo, hi)


def square(a):
    return mul(a, a)


def exp7(a):
    """a^7 — the Poseidon S-box. 4 field muls."""
    a2 = square(a)
    a3 = mul(a2, a)
    a6 = square(a3)
    return mul(a6, a)


def neg(a):
    """(-a) mod p: p - a, and 0 for 0."""
    return torch.where(a == 0, a, to_i64(P) - a)


def mul_small(a, k: int):
    """(a * k) mod p for a small constant 0 <= k < 2^20: two 32-bit limbs
    times k (each product < 2^52), joined into a < 2^84 value, reduced."""
    if not 0 <= k < 1 << 20:
        raise ValueError(f"mul_small takes 0 <= k < 2^20, got {k}")
    lo_k = (a & _M32) * k
    hi_k = _hi32(a) * k
    lo = lo_k + (hi_k << 32)
    hi = (hi_k >> 32) + _ult(lo, lo_k).to(lo.dtype)
    return _reduce128(lo, hi)


def inverse(a):
    """a^(p-2): the field inverse by Fermat (0 maps to 0), one square and,
    where the exponent bit is set, one multiply for each of its 64 bits."""
    e = P - 2
    acc = torch.ones_like(a)
    base = a
    for i in range(64):
        if (e >> i) & 1:
            acc = mul(acc, base)
        base = square(base)
    return acc


def reduce_add(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Sum mod p along `dim`, as a tree of elementwise adds (log2 of the
    length of passes; the sum is exact, so its order does not matter)."""
    x = x.movedim(dim, 0)
    while x.shape[0] > 1:
        h = x.shape[0] // 2
        y = add(x[:h], x[h:2 * h])
        x = torch.cat([y, x[2 * h:]]) if x.shape[0] % 2 else y
    return x[0]


def eq(a, b):
    return a == b


def is_zero(a):
    return a == 0


def select(mask, a, b):
    """Elementwise mask ? a : b."""
    return torch.where(mask, a, b)


def zeros(shape, device=None) -> torch.Tensor:
    return torch.zeros(shape, dtype=torch.int64, device=device)


def full(shape, value: int, device=None) -> torch.Tensor:
    """A tensor of the canonical value `value mod p`."""
    return torch.full(shape, to_i64(int(value) % P), dtype=torch.int64,
                      device=device)


# ---------------------------------------------------------------------------
# Host-side vectorized exact ops (numpy uint64; for large constant tables)
# ---------------------------------------------------------------------------

_NP_MASK32 = np.uint64(0xFFFFFFFF)
_NP_EPS = np.uint64(0xFFFFFFFF)

# uint64 wraparound is intentional throughout (mod-2^64 limb arithmetic);
# numpy only warns for 0-d scalars, which show up on single-element inputs.
np.seterr(over="ignore")


def np_mul(a, b) -> np.ndarray:
    """Exact (a * b) mod p on numpy uint64 arrays (vectorized host twin of mul)."""
    a = np.asarray(a, dtype=np.uint64)
    b = np.asarray(b, dtype=np.uint64)
    alo = a & _NP_MASK32
    ahi = a >> np.uint64(32)
    blo = b & _NP_MASK32
    bhi = b >> np.uint64(32)
    ll = alo * blo                       # exact, < 2^64
    lh = alo * bhi
    hl = ahi * blo
    hh = ahi * bhi
    # mid = lh + hl + (ll >> 32), tracking carry into the high 64 bits
    mid = lh + hl
    c_mid = (mid < hl).astype(np.uint64)
    mid2 = mid + (ll >> np.uint64(32))
    c_mid += (mid2 < (ll >> np.uint64(32))).astype(np.uint64)
    lo64 = (ll & _NP_MASK32) | (mid2 << np.uint64(32))
    hi64 = hh + (mid2 >> np.uint64(32)) + (c_mid << np.uint64(32))
    # reduce n = lo64 + hi64 * 2^64 mod p, via 2^64 = eps, 2^96 = -1:
    #   n = lo64 - hi_hi + hi_lo * eps
    hi_lo = hi64 & _NP_MASK32
    hi_hi = hi64 >> np.uint64(32)
    t = lo64 - hi_hi
    borrow = (lo64 < hi_hi).astype(np.uint64)
    t -= borrow * _NP_EPS                # wrapped: subtract eps on borrow
    mid_term = hi_lo * _NP_EPS           # < 2^64, exact
    r = t + mid_term
    carry = (r < mid_term).astype(np.uint64)
    r += carry * _NP_EPS
    # canonicalize (one conditional subtract)
    geq = r >= np.uint64(P)
    r = np.where(geq, r - np.uint64(P), r)
    return r


def np_add(a, b) -> np.ndarray:
    """Exact (a + b) mod p on numpy uint64 arrays."""
    a = np.asarray(a, dtype=np.uint64)
    b = np.asarray(b, dtype=np.uint64)
    s = a + b
    carry = s < a                       # wrapped past 2^64: add EPSILON back
    s = np.where(carry, s + _NP_EPS, s)
    geq = s >= np.uint64(P)
    return np.where(geq, s - np.uint64(P), s)


def np_sub(a, b) -> np.ndarray:
    a = np.asarray(a, dtype=np.uint64)
    b = np.asarray(b, dtype=np.uint64)
    return np_add(a, np.where(b == 0, np.uint64(0), np.uint64(P) - b))


def np_pow(a, e: int) -> np.ndarray:
    """Elementwise a^e mod p (square-and-multiply over a fixed exponent)."""
    a = np.asarray(a, dtype=np.uint64)
    result = np.ones_like(a)
    base = a
    while e > 0:
        if e & 1:
            result = np_mul(result, base)
        base = np_mul(base, base)
        e >>= 1
    return result


def np_inverse(a) -> np.ndarray:
    """Elementwise modular inverse (vectorized host path for permutation-
    argument denominators and opening-quotient division). Montgomery-style
    batch inversion over a pairwise product tree: ~3 multiplies per element
    + ONE scalar exponentiation, vs ~96 multiply-passes for elementwise
    Fermat. Zeros map to zero (Fermat semantics preserved)."""
    a = np.asarray(a, dtype=np.uint64)
    flat = a.reshape(-1)
    n = flat.size
    if n == 0:
        return a.copy()
    if n == 1:
        v = int(flat[0])
        inv = pow(v, P - 2, P) if v else 0
        return np.full(a.shape, inv, dtype=np.uint64)
    zero_mask = flat == 0
    vals = np.where(zero_mask, np.uint64(1), flat)
    m = 1 << (n - 1).bit_length()
    buf = np.ones(m, dtype=np.uint64)
    buf[:n] = vals
    levels = [buf]
    cur = buf
    while cur.size > 1:
        cur = np_mul(cur[0::2], cur[1::2])
        levels.append(cur)
    inv = np.array([pow(int(cur[0]), P - 2, P)], dtype=np.uint64)
    for lvl in reversed(levels[:-1]):
        left, right = lvl[0::2], lvl[1::2]
        inv_left = np_mul(inv, right)
        inv_right = np_mul(inv, left)
        nxt = np.empty_like(lvl)
        nxt[0::2] = inv_left
        nxt[1::2] = inv_right
        inv = nxt
    out = np.where(zero_mask, np.uint64(0), inv[:n])
    return out.reshape(a.shape)


def np_powers(base: int, n: int) -> np.ndarray:
    """[base^0, base^1, ..., base^(n-1)] mod p as uint64, via log-doubling."""
    if n <= 0:
        return np.empty(0, dtype=np.uint64)
    out = np.ones(1, dtype=np.uint64)
    cur = np.uint64(base % P)
    while len(out) < n:
        out = np.concatenate([out, np_mul(out, cur)])
        cur = np_mul(cur, cur)[()] if np.ndim(cur) == 0 else np_mul(cur, cur)
        cur = np.uint64(cur)
    return out[:n]


# ---------------------------------------------------------------------------
# Host-side exact scalar helpers (python ints; for twiddle tables, tests)
# ---------------------------------------------------------------------------

def h_mul(a: int, b: int) -> int:
    return (a * b) % P


def h_add(a: int, b: int) -> int:
    return (a + b) % P


def h_exp(a: int, e: int) -> int:
    return pow(a, e, P)


def h_inverse(a: int) -> int:
    return pow(a, P - 2, P)


def h_primitive_root_of_unity(n_log: int) -> int:
    """2^n_log-th primitive root of unity (matches plonky2's subgroup generator)."""
    assert 0 <= n_log <= TWO_ADICITY
    base = POWER_OF_TWO_GENERATOR
    for _ in range(TWO_ADICITY - n_log):
        base = (base * base) % P
    return base
