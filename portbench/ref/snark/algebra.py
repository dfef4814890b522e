"""Evaluation algebras: one gate-constraint definition, several backends.

Counterpart of the port's ``snark/algebra.py``. Every gate expresses its
constraints once against this small interface; the host verifier
evaluates them at one extension point (``HostExtAlg``: python ints), the
recursion gadget in-circuit. (The prover's int64-tensor backend is the
program's and is not copied.)

Interface (elements are backend-specific):
  add(a, b), sub(a, b), mul(a, b)         -- ring ops
  cmul(c, x), cadd(c, x)                  -- literal-int constant * / +
  const_like(c, like)                     -- lift a literal int near `like`
"""

from __future__ import annotations

from ..core import gl64, gl64_ext

P = gl64.P


class HostExtAlg:
    """Extension-field points as (int, int) tuples — exact host math."""
    add = staticmethod(gl64_ext.h_add)
    sub = staticmethod(gl64_ext.h_sub)
    mul = staticmethod(gl64_ext.h_mul)

    @staticmethod
    def cmul(c, x):
        c = c % P
        return ((c * x[0]) % P, (c * x[1]) % P)

    @staticmethod
    def cadd(c, x):
        return ((x[0] + c) % P, x[1])

    @staticmethod
    def const_like(c, like):
        return (c % P, 0)


def _lit(c) -> int:
    """A literal int as the int64 bit pattern of its canonical value, an
    operand the gl64 ops broadcast like a 0-d tensor."""
    return gl64.to_i64(int(c) % P)


def lift_host(v: int):
    return (v % P, 0)
