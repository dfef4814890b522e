"""Nonnative big-integer gadgets over Goldilocks: fixed-width unsigned
integers as vectors of 16-bit limb targets, with witness-hinted modular
reduction. The foundation of the in-circuit secp256k1 ECDSA verifier.

Reference role: city_common_circuit/src/crypto/secp256k1/ecdsa/gadgets/
{biguint, nonnative, split_nonnative}.rs (SURVEY.md §2.2 "secp256k1 ECDSA
in-circuit"). The reference uses 32-bit limbs with custom u32 gates; here
limbs are 16 bits so every convolution column sum (≤ 32 terms of < 2^32
plus carries < 2^41) stays far below p and lands on the two batched row
kernels (ArithmeticGate + BaseSumGate) the device prover already evaluates
at full LDE width — no bespoke gate kernels needed.

Layout invariant: a BigUintTarget of k limbs represents
sum(limb[i] * 2^(16 i)), each limb range-checked to 16 bits at creation.

Counterpart of the reference's ``snark/biguint.py``: the same code over the port's
``core/`` and ``snark/`` (host Python; the proofs it builds circuits for
run on the port's prover).
"""

from __future__ import annotations

import dataclasses

from ..core import gl64

P = gl64.P
LIMB_BITS = 16
LIMB_BASE = 1 << LIMB_BITS


def int_to_limbs(v: int, n_limbs: int) -> list[int]:
    assert 0 <= v < (1 << (LIMB_BITS * n_limbs))
    return [(v >> (LIMB_BITS * i)) & (LIMB_BASE - 1) for i in range(n_limbs)]


def limbs_to_int(limbs: list[int]) -> int:
    v = 0
    for i, limb in enumerate(limbs):
        v |= int(limb) << (LIMB_BITS * i)
    return v


@dataclasses.dataclass
class BigUintTarget:
    limbs: list                     # limb targets, little-endian

    @property
    def n_limbs(self) -> int:
        return len(self.limbs)


class BigUintBuilder:
    """BigUint gadget namespace over a CircuitBuilder
    (CircuitBuilderBiguint twin)."""

    def __init__(self, b):
        self.b = b

    # -- creation ------------------------------------------------------------
    def add_virtual_biguint(self, n_limbs: int) -> BigUintTarget:
        b = self.b
        limbs = []
        for _ in range(n_limbs):
            t = b.add_virtual_target()
            b.range_check(t, LIMB_BITS)
            limbs.append(t)
        return BigUintTarget(limbs)

    def constant_biguint(self, v: int, n_limbs: int) -> BigUintTarget:
        return BigUintTarget([self.b.constant(x)
                              for x in int_to_limbs(v, n_limbs)])

    def set_biguint(self, pw, t: BigUintTarget, v: int):
        for limb_t, limb_v in zip(t.limbs, int_to_limbs(v, t.n_limbs)):
            pw.set(limb_t, limb_v)

    def get_biguint(self, pw, t: BigUintTarget) -> int:
        return limbs_to_int([pw.get(x) or 0 for x in t.limbs])

    # -- felt packing ----------------------------------------------------------
    def pack_felts(self, t: BigUintTarget, bits_per_felt: int = 48) -> list:
        """Pack limbs into wider felts (for Poseidon hashing of nonnative
        values, e.g. the combined signature hash)."""
        b = self.b
        per = bits_per_felt // LIMB_BITS
        out = []
        for i in range(0, t.n_limbs, per):
            acc = b.zero()
            for j, limb in enumerate(t.limbs[i:i + per]):
                acc = b.arithmetic(1 << (LIMB_BITS * j), 1, limb, b.one(),
                                   acc)
            out.append(acc)
        return out

    # -- comparison ------------------------------------------------------------
    def assert_lt(self, a: BigUintTarget, m: int):
        """a < m for a constant modulus m: witness-free borrow-chain check
        on (m-1) - a >= 0 done limb-wise with borrow hints."""
        b = self.b
        n = a.n_limbs
        top = int_to_limbs(m - 1, n)
        borrows = [b.add_virtual_target() for _ in range(n)]

        def gen(pw, _a=list(a.limbs), _bo=borrows, _top=top):
            borrow = 0
            for i in range(len(_a)):
                d = _top[i] - (pw.get(_a[i]) or 0) - borrow
                borrow = 1 if d < 0 else 0
                pw.set(_bo[i], borrow)

        b.add_generator(gen, deps=list(a.limbs))
        borrow_in = b.zero()
        for i in range(n):
            # diff_i = top_i - a_i - borrow_in + borrow_out * 2^16 in [0, 2^16)
            diff = b.add(b.sub(b.constant(top[i]), a.limbs[i]),
                         b.arithmetic(LIMB_BASE, P - 1, borrows[i], b.one(),
                                      borrow_in))
            b.range_check(diff, LIMB_BITS)
            b.range_check(borrows[i], 1)
            borrow_in = borrows[i]
        # final borrow must be 0 (no underflow => a <= m-1)
        b.assert_zero(borrow_in)

    def assert_equal(self, a: BigUintTarget, c: BigUintTarget):
        assert a.n_limbs == c.n_limbs
        for x, y in zip(a.limbs, c.limbs):
            self.b.connect(x, y)

    # -- addition ---------------------------------------------------------------
    def add(self, a: BigUintTarget, c: BigUintTarget) -> BigUintTarget:
        """Full-width sum (output has max(n)+1 limbs)."""
        b = self.b
        n = max(a.n_limbs, c.n_limbs)
        out = self.add_virtual_biguint(n + 1)
        carries = [b.add_virtual_target() for _ in range(n)]

        def gen(pw, _a=list(a.limbs), _c=list(c.limbs), _o=list(out.limbs),
                _ca=carries):
            carry = 0
            for i in range(len(_o) - 1):
                s = ((pw.get(_a[i]) or 0) if i < len(_a) else 0) + \
                    ((pw.get(_c[i]) or 0) if i < len(_c) else 0) + carry
                pw.set(_o[i], s % LIMB_BASE)
                carry = s // LIMB_BASE
                pw.set(_ca[i], carry)
            pw.set(_o[-1], carry)

        b.add_generator(gen, deps=list(a.limbs) + list(c.limbs))
        carry_in = b.zero()
        for i in range(n):
            ai = a.limbs[i] if i < a.n_limbs else b.zero()
            ci = c.limbs[i] if i < c.n_limbs else b.zero()
            s = b.add(b.add(ai, ci), carry_in)
            # s == out_i + carry_i * 2^16
            recomb = b.arithmetic(LIMB_BASE, 1, carries[i], b.one(),
                                  out.limbs[i])
            b.connect(s, recomb)
            b.range_check(carries[i], 1)
            carry_in = carries[i]
        b.connect(out.limbs[n], carry_in)
        return out

    # -- multiplication -----------------------------------------------------------
    def mul(self, a: BigUintTarget, c: BigUintTarget) -> BigUintTarget:
        """Full product via limb convolution with carry chain. Column sums
        are < min(na,nc) * 2^32 + carry < 2^38 — far below p."""
        b = self.b
        na, nc = a.n_limbs, c.n_limbs
        n_out = na + nc
        out = self.add_virtual_biguint(n_out)
        carries = [b.add_virtual_target() for _ in range(n_out)]
        carry_bits = 32 + max(na, nc).bit_length()

        def gen(pw, _a=list(a.limbs), _c=list(c.limbs), _o=list(out.limbs),
                _ca=carries):
            av = [pw.get(t) or 0 for t in _a]
            cv = [pw.get(t) or 0 for t in _c]
            carry = 0
            for k in range(len(_o)):
                s = carry
                for i in range(max(0, k - len(cv) + 1), min(k + 1, len(av))):
                    s += av[i] * cv[k - i]
                pw.set(_o[k], s % LIMB_BASE)
                carry = s // LIMB_BASE
                pw.set(_ca[k], carry)

        b.add_generator(gen, deps=list(a.limbs) + list(c.limbs))
        carry_in = b.zero()
        for k in range(n_out):
            s = carry_in
            for i in range(max(0, k - nc + 1), min(k + 1, na)):
                s = b.mul_add(a.limbs[i], c.limbs[k - i], s)
            recomb = b.arithmetic(LIMB_BASE, 1, carries[k], b.one(),
                                  out.limbs[k])
            b.connect(s, recomb)
            b.range_check(carries[k], carry_bits)
            carry_in = carries[k]
        b.assert_zero(carry_in)
        return out

    def mul_const(self, a: BigUintTarget, m: int,
                  n_out: int | None = None) -> BigUintTarget:
        """a * m for constant m (convolution with constant limbs)."""
        b = self.b
        mlimbs = int_to_limbs(m, (m.bit_length() + LIMB_BITS - 1) //
                              LIMB_BITS or 1)
        na, nc = a.n_limbs, len(mlimbs)
        n_out = n_out or (na + nc)
        out = self.add_virtual_biguint(n_out)
        carries = [b.add_virtual_target() for _ in range(n_out)]
        carry_bits = 32 + max(na, nc).bit_length()

        def gen(pw, _a=list(a.limbs), _o=list(out.limbs), _ca=carries,
                _m=mlimbs):
            av = [pw.get(t) or 0 for t in _a]
            carry = 0
            for k in range(len(_o)):
                s = carry
                for i in range(max(0, k - len(_m) + 1), min(k + 1, len(av))):
                    s += av[i] * _m[k - i]
                pw.set(_o[k], s % LIMB_BASE)
                carry = s // LIMB_BASE
                pw.set(_ca[k], carry)

        b.add_generator(gen, deps=list(a.limbs))
        carry_in = b.zero()
        for k in range(n_out):
            s = carry_in
            for i in range(max(0, k - nc + 1), min(k + 1, na)):
                s = b.arithmetic(mlimbs[k - i], 1, a.limbs[i], b.one(), s)
            recomb = b.arithmetic(LIMB_BASE, 1, carries[k], b.one(),
                                  out.limbs[k])
            b.connect(s, recomb)
            b.range_check(carries[k], carry_bits)
            carry_in = carries[k]
        b.assert_zero(carry_in)
        return out

    # -- modular reduction ----------------------------------------------------------
    def reduce_mod(self, x: BigUintTarget, m: int,
                   n_limbs: int) -> BigUintTarget:
        """x mod m for a constant modulus: witness-hinted (q, r) with
        x == q*m + r and r < m (nonnative.rs reduce twin)."""
        b = self.b
        q_limbs = max(1, x.n_limbs - (m.bit_length() - 1) // LIMB_BITS + 1)
        q = self.add_virtual_biguint(q_limbs)
        r = self.add_virtual_biguint(n_limbs)

        def gen(pw, _x=list(x.limbs), _q=list(q.limbs), _r=list(r.limbs),
                _m=m):
            v = limbs_to_int([pw.get(t) or 0 for t in _x])
            qq, rr = divmod(v, _m)
            for t, lv in zip(_q, int_to_limbs(qq, len(_q))):
                pw.set(t, lv)
            for t, lv in zip(_r, int_to_limbs(rr, len(_r))):
                pw.set(t, lv)

        b.add_generator(gen, deps=list(x.limbs))
        qm = self.mul_const(q, m)
        qm_r = self.add(qm, r)
        # x == qm + r, compared over the wider of the two widths
        w = max(qm_r.n_limbs, x.n_limbs)
        for i in range(w):
            xi = x.limbs[i] if i < x.n_limbs else b.zero()
            yi = qm_r.limbs[i] if i < qm_r.n_limbs else b.zero()
            b.connect(xi, yi)
        self.assert_lt(r, m)
        return r

    def mul_mod(self, a: BigUintTarget, c: BigUintTarget, m: int
                ) -> BigUintTarget:
        n = (m.bit_length() + LIMB_BITS - 1) // LIMB_BITS
        return self.reduce_mod(self.mul(a, c), m, n)

    def add_mod(self, a: BigUintTarget, c: BigUintTarget, m: int
                ) -> BigUintTarget:
        n = (m.bit_length() + LIMB_BITS - 1) // LIMB_BITS
        return self.reduce_mod(self.add(a, c), m, n)

    def sub_mod(self, a: BigUintTarget, c: BigUintTarget, m: int
                ) -> BigUintTarget:
        """(a - c) mod m via a + (m - c-as-value) hint-free trick:
        a + (m*1) - c computed as a + m_const then subtract — implemented
        as reduce(a + (m - c)) with (m - c) from a hinted complement that
        is verified by c + comp == m (all constants known widths)."""
        b = self.b
        n = (m.bit_length() + LIMB_BITS - 1) // LIMB_BITS
        comp = self.add_virtual_biguint(n)

        def gen(pw, _c=list(c.limbs), _comp=list(comp.limbs), _m=m):
            cv = limbs_to_int([pw.get(t) or 0 for t in _c]) % _m
            for t, lv in zip(_comp, int_to_limbs((_m - cv) % _m, len(_comp))):
                pw.set(t, lv)

        b.add_generator(gen, deps=list(c.limbs))
        # c + comp ≡ 0 mod m  (and both < m ⇒ c + comp ∈ {0, m})
        csum = self.add(c, comp)
        zero_r = self.reduce_mod(csum, m, n)
        for limb in zero_r.limbs:
            b.assert_zero(limb)
        self.assert_lt(comp, m)
        return self.add_mod(a, comp, m)

    def inv_mod(self, a: BigUintTarget, m: int) -> BigUintTarget:
        """Witness-hinted modular inverse: a * inv ≡ 1 (mod m), inv < m.
        Also proves a is invertible (nonzero mod m)."""
        b = self.b
        n = (m.bit_length() + LIMB_BITS - 1) // LIMB_BITS
        inv = self.add_virtual_biguint(n)

        def gen(pw, _a=list(a.limbs), _inv=list(inv.limbs), _m=m):
            v = limbs_to_int([pw.get(t) or 0 for t in _a]) % _m
            iv = pow(v, -1, _m)
            for t, lv in zip(_inv, int_to_limbs(iv, len(_inv))):
                pw.set(t, lv)

        b.add_generator(gen, deps=list(a.limbs))
        prod = self.mul_mod(a, inv, m)
        b.connect(prod.limbs[0], b.one())
        for limb in prod.limbs[1:]:
            b.assert_zero(limb)
        self.assert_lt(inv, m)
        return inv

    # -- bit decomposition -------------------------------------------------------
    def to_bits(self, a: BigUintTarget) -> list:
        """All limbs split into routable LE bits (for scalar-mul loops)."""
        from .gadgets import split_le_16
        bits = []
        for limb in a.limbs:
            bits.extend(split_le_16(self.b, limb))
        return bits
