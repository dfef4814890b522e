"""u32 gadget layer: 32-bit arithmetic, comparison, and bitwise ops over
Goldilocks targets.

Reference role: city_common_circuit/src/u32/gates/* + gadgets/* (SURVEY.md
§2.2) — the eight custom u32 gates (arithmetic_u32, add_many_u32,
subtraction_u32, comparison, range_check_u32, interleave_u32,
uninterleave_*) and the U32Target gadget API built on them. TPU-first
design note: instead of eight bespoke per-row constraint kernels, every u32
op lowers onto the two batched row kernels the device prover already
evaluates at full LDE width (ArithmeticGate, BaseSumGate) — same constraint
system family, but the constraint-evaluation work stays in two large fused
device kernels rather than many small ones. Bitwise ops use the boolean
decomposition identities (x^y = x+y-2xy per bit) rather than the reference's
interleave trick, which exists only to dodge CPU bit-shuffle costs.

Key safety invariant (same as plonky2's U32ArithmeticGate): a*b + c with
a,b,c < 2^32 has maximum (2^32-1)^2 + (2^32-1) = 2^64 - 2^32 < p, so a
single mul-add never wraps the field.

Counterpart of the reference's ``snark/u32.py``: the same code over the port's
``core/`` and ``snark/`` (host Python; the proofs it builds circuits for
run on the port's prover).
"""

from __future__ import annotations

import dataclasses

from ..core import gl64

P = gl64.P
B32 = 1 << 32


@dataclasses.dataclass(frozen=True)
class U32Target:
    """A target constrained (by its producing gadget) to [0, 2^32)."""
    target: object


class U32Builder:
    """u32 gadget namespace over a CircuitBuilder (gadgets/arithmetic_u32.rs
    CircuitBuilderU32 equivalent)."""

    def __init__(self, b):
        self.b = b

    # -- creation ---------------------------------------------------------
    def add_virtual_u32(self) -> U32Target:
        t = self.b.add_virtual_target()
        # route through a range check row so provers must supply < 2^32
        self.b.range_check(t, 32)
        return U32Target(t)

    def constant_u32(self, v: int) -> U32Target:
        assert 0 <= v < B32
        return U32Target(self.b.constant(v))

    def zero_u32(self) -> U32Target:
        return U32Target(self.b.zero())

    # -- arithmetic ---------------------------------------------------------
    def add_u32(self, a: U32Target, b: U32Target
                ) -> tuple[U32Target, U32Target]:
        """(sum mod 2^32, carry) — arithmetic_u32.rs add_u32."""
        return self.add_many_u32([a, b])

    def add_many_u32(self, xs: list[U32Target]
                     ) -> tuple[U32Target, U32Target]:
        """Σ xs = out + carry·2^32 (add_many_u32.rs). len(xs) ≤ 2^32 terms
        would overflow; we allow ≤ 2^31 which covers every caller."""
        assert 1 <= len(xs) < (1 << 31)
        b = self.b
        total = xs[0].target
        for x in xs[1:]:
            total = b.add(total, x.target)
        out = b.add_virtual_target()
        carry = b.add_virtual_target()
        # total == out + carry * 2^32
        recomb = b.arithmetic(B32 % P, 1, carry, b.one(), out)
        b.connect(total, recomb)
        b.range_check(out, 32)
        carry_bits = max(1, (len(xs) - 1).bit_length())
        b.range_check(carry, carry_bits)
        b.add_generator(lambda pw, _t=total, _o=out, _c=carry: (
            None if pw.get(_t) is None else
            (pw.set(_o, pw.get(_t) % B32), pw.set(_c, pw.get(_t) // B32))),
            deps=[total])
        return U32Target(out), U32Target(carry)

    def mul_add_u32(self, a: U32Target, b_: U32Target, c: U32Target
                    ) -> tuple[U32Target, U32Target]:
        """a*b + c = lo + hi·2^32 (arithmetic_u32.rs U32ArithmeticGate)."""
        b = self.b
        total = b.arithmetic(1, 1, a.target, b_.target, c.target)
        lo = b.add_virtual_target()
        hi = b.add_virtual_target()
        recomb = b.arithmetic(B32 % P, 1, hi, b.one(), lo)
        b.connect(total, recomb)
        b.range_check(lo, 32)
        b.range_check(hi, 32)
        b.add_generator(lambda pw, _t=total, _lo=lo, _hi=hi: (
            None if pw.get(_t) is None else
            (pw.set(_lo, pw.get(_t) % B32), pw.set(_hi, pw.get(_t) // B32))),
            deps=[total])
        return U32Target(lo), U32Target(hi)

    def sub_u32(self, a: U32Target, b_: U32Target
                ) -> tuple[U32Target, U32Target]:
        """a - b = out - borrow·2^32, borrow ∈ {0,1} (subtraction_u32.rs)."""
        b = self.b
        out = b.add_virtual_target()
        borrow = b.add_virtual_target()
        # a - b + borrow*2^32 == out
        lhs = b.add(b.sub(a.target, b_.target),
                    b.mul_const(B32 % P, borrow))
        b.connect(lhs, out)
        b.range_check(out, 32)
        b.range_check(borrow, 1)
        b.add_generator(lambda pw, _a=a.target, _b=b_.target, _o=out,
                        _w=borrow: (
            None if pw.get(_a) is None or pw.get(_b) is None else
            (pw.set(_o, (pw.get(_a) - pw.get(_b)) % B32),
             pw.set(_w, 1 if pw.get(_a) < pw.get(_b) else 0))),
            deps=[a.target, b_.target])
        return U32Target(out), U32Target(borrow)

    # -- comparison -----------------------------------------------------------
    def assert_lte_u32(self, a: U32Target, b_: U32Target):
        """a ≤ b (comparison.rs ComparisonGate role — every balance check)."""
        self.b.range_check(self.b.sub(b_.target, a.target), 32)

    def is_lte_u32(self, a: U32Target, b_: U32Target):
        """Returns a BoolTarget-like target: 1 iff a ≤ b (multiple_comparison
        list_lte role). Computed via the subtraction borrow bit."""
        _, borrow = self.sub_u32(b_, a)
        return self.b.sub(self.b.one(), borrow.target)

    # -- bitwise ---------------------------------------------------------------
    def split_bits(self, a: U32Target) -> list:
        """32 ROUTABLE LE bit targets of a (binary_u32.rs): two BaseSum(16)
        rows (a single 32-bit row would park bit 31 in a non-routed
        column)."""
        from .gadgets import split_le_16
        b = self.b
        lo = b.add_virtual_target()
        hi = b.add_virtual_target()

        def gen(pw, _a=a.target, _lo=lo, _hi=hi):
            v = pw.get(_a)
            if v is None or pw.get(_lo) is not None:
                return
            pw.set(_lo, v & 0xFFFF)
            pw.set(_hi, (v >> 16) & 0xFFFF)

        b.add_generator(gen, deps=[a.target])
        b.connect(b.arithmetic(1 << 16, 1, hi, b.one(), lo), a.target)
        return split_le_16(b, lo) + split_le_16(b, hi)

    def from_bits(self, bits: list) -> U32Target:
        b = self.b
        acc = b.zero()
        for i, bit in enumerate(bits):
            acc = b.arithmetic(pow(2, i, P), 1, bit, b.one(), acc)
        return U32Target(acc)

    def _bitwise(self, a: U32Target, b_: U32Target, op) -> U32Target:
        ab = self.split_bits(a)
        bb = self.split_bits(b_)
        return self.from_bits([op(x, y) for x, y in zip(ab, bb)])

    def xor_u32(self, a: U32Target, b_: U32Target) -> U32Target:
        """x^y per bit: x + y - 2xy (interleave_u32.rs role)."""
        b = self.b
        return self._bitwise(
            a, b_, lambda x, y: b.arithmetic(P - 2, 1, x, y, b.add(x, y)))

    def and_u32(self, a: U32Target, b_: U32Target) -> U32Target:
        return self._bitwise(a, b_, self.b.mul)

    def not_u32(self, a: U32Target) -> U32Target:
        return U32Target(self.b.sub(self.b.constant(B32 - 1), a.target))

    def rotr_u32(self, a: U32Target, n: int) -> U32Target:
        bits = self.split_bits(a)
        return self.from_bits(bits[n:] + bits[:n])

    def shr_u32(self, a: U32Target, n: int) -> U32Target:
        bits = self.split_bits(a)
        return self.from_bits(bits[n:] + [self.b.zero()] * n)

    # -- witness ---------------------------------------------------------------
    def set_u32(self, pw, t: U32Target, v: int):
        assert 0 <= v < B32
        pw.set(t.target, v)
