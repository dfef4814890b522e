"""Quadratic extension GF(p^2) of Goldilocks, X^2 = W = 7.

Counterpart of the reference's ``core/gl64_ext.py``. An element is a pair
``(a0, a1)`` of int64 tensors (see ``gl64``), standing for a0 + a1·X. FRI
folds its codewords in this field. The vectorized host ops (``np_ext_*``,
numpy uint64 pairs) and the python-int host twins (``h_*``, ``(int, int)``
tuples) are copies of the reference's.
"""

from __future__ import annotations

import numpy as np

from . import gl64

W = 7                       # X^2 = W
P = gl64.P
# Frobenius: x^p = a0 - a1·X, since W^((p-1)/2) = -1 for the non-residue W.
DTH_ROOT = P - 1


def from_base(a):
    """Lift a base-field element to the extension: a + 0·X."""
    return (a, a.new_zeros(a.shape))


def zeros(shape, device=None):
    return (gl64.zeros(shape, device), gl64.zeros(shape, device))


def add(a, b):
    return (gl64.add(a[0], b[0]), gl64.add(a[1], b[1]))


def sub(a, b):
    return (gl64.sub(a[0], b[0]), gl64.sub(a[1], b[1]))


def neg(a):
    return (gl64.neg(a[0]), gl64.neg(a[1]))


def mul(a, b):
    """(a0 + a1 X)(b0 + b1 X) = (a0 b0 + W a1 b1) + (a0 b1 + a1 b0) X.

    5 base muls (Karatsuba on the cross term: (a0+a1)(b0+b1) - a0b0 - a1b1).
    """
    a0, a1 = a
    b0, b1 = b
    t00 = gl64.mul(a0, b0)
    t11 = gl64.mul(a1, b1)
    s_a = gl64.add(a0, a1)
    s_b = gl64.add(b0, b1)
    cross = gl64.sub(gl64.sub(gl64.mul(s_a, s_b), t00), t11)
    c0 = gl64.add(t00, gl64.mul_small(t11, W))
    return (c0, cross)


def mul_base(a, b):
    """Extension * base-field element."""
    return (gl64.mul(a[0], b), gl64.mul(a[1], b))


def square(a):
    return mul(a, a)


def inverse(a):
    """1 / (a0 + a1 X) = (a0 - a1 X) / (a0^2 - W a1^2)."""
    a0, a1 = a
    norm = gl64.sub(gl64.mul(a0, a0), gl64.mul_small(gl64.mul(a1, a1), W))
    inv_norm = gl64.inverse(norm)
    return (gl64.mul(a0, inv_norm), gl64.mul(gl64.neg(a1), inv_norm))


def select(mask, a, b):
    return (gl64.select(mask, a[0], b[0]), gl64.select(mask, a[1], b[1]))


def eq(a, b):
    return gl64.eq(a[0], b[0]) & gl64.eq(a[1], b[1])


# ---------------------------------------------------------------------------
# Vectorized host ops (numpy uint64 pairs (a0, a1))
# ---------------------------------------------------------------------------

def np_ext_add(a, b):
    return (gl64.np_add(a[0], b[0]), gl64.np_add(a[1], b[1]))


def np_ext_sub(a, b):
    return (gl64.np_sub(a[0], b[0]), gl64.np_sub(a[1], b[1]))


def np_ext_mul(a, b):
    t00 = gl64.np_mul(a[0], b[0])
    t11 = gl64.np_mul(a[1], b[1])
    cross = gl64.np_sub(
        gl64.np_mul(gl64.np_add(a[0], a[1]), gl64.np_add(b[0], b[1])),
        gl64.np_add(t00, t11))
    c0 = gl64.np_add(t00, gl64.np_mul(t11, np.uint64(W)))
    return (c0, cross)


def np_ext_scale(a, s):
    """Ext array * ext scalar (s: (int, int))."""
    sv = (np.uint64(s[0]), np.uint64(s[1]))
    return np_ext_mul(a, (np.broadcast_to(sv[0], np.shape(a[0])),
                          np.broadcast_to(sv[1], np.shape(a[1]))))


def np_ext_inverse(a):
    norm = gl64.np_sub(gl64.np_mul(a[0], a[0]),
                       gl64.np_mul(gl64.np_mul(a[1], a[1]), np.uint64(W)))
    inv = gl64.np_inverse(norm)
    return (gl64.np_mul(a[0], inv),
            gl64.np_mul(gl64.np_sub(np.zeros_like(a[1]), a[1]), inv))


# ---------------------------------------------------------------------------
# Host twins (python ints): elements are (int, int) tuples
# ---------------------------------------------------------------------------

def h_add(a, b):
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def h_sub(a, b):
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def h_mul(a, b):
    c0 = (a[0] * b[0] + W * a[1] * b[1]) % P
    c1 = (a[0] * b[1] + a[1] * b[0]) % P
    return (c0, c1)


def h_inverse(a):
    norm = (a[0] * a[0] - W * a[1] * a[1]) % P
    inv = pow(norm, P - 2, P)
    return ((a[0] * inv) % P, (-a[1] * inv) % P)


def h_exp(a, e: int):
    result = (1, 0)
    base = a
    while e > 0:
        if e & 1:
            result = h_mul(result, base)
        base = h_mul(base, base)
        e >>= 1
    return result


def h_eval_poly_ext(coeffs_base: list[int], x) -> tuple[int, int]:
    """Evaluate a base-field-coefficient polynomial at an extension point."""
    acc = (0, 0)
    for c in reversed(coeffs_base):
        acc = h_mul(acc, x)
        acc = ((acc[0] + c) % P, acc[1])
    return acc
