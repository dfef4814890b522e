"""In-circuit gadget layer: extension-field arithmetic over targets, bit
decomposition, Merkle-path verification, Horner reductions, and the circuit
algebra that lets every Gate evaluate its own constraints *inside* another
circuit (the recursive verifier's core trick).

Reference role: plonky2's `CircuitBuilder` extension-target ops +
`city_common_circuit` builder extensions (SURVEY.md §2.2 "Builder
extensions"; §2.14 `field::extension::Extendable` gadget surface).

Counterpart of the reference's ``snark/gadgets.py``: the same code over the port's
``core/`` and ``snark/`` (host Python; the proofs it builds circuits for
run on the port's prover).
"""

from __future__ import annotations

from ..core import gl64, gl64_ext
from .circuit import CircuitBuilder, Target
from .gates import BaseSumGate, ReducingExtGate, ReducingGate

P = gl64.P
W_EXT = gl64_ext.W

# An extension target is a pair of base targets (a0, a1) = a0 + a1·X.
ExtTarget = tuple


class ExtGadgets:
    """Extension-field (GF(p^2), X^2=7) arithmetic over circuit targets."""

    def __init__(self, b: CircuitBuilder):
        self.b = b

    # -- lifting ------------------------------------------------------------
    def ext(self, t: Target) -> ExtTarget:
        """Lift a base target: t + 0·X."""
        return (t, self.b.zero())

    def const_ext(self, v) -> ExtTarget:
        """Lift an (int, int) extension constant."""
        return (self.b.constant(v[0]), self.b.constant(v[1]))

    def zero(self) -> ExtTarget:
        z = self.b.zero()
        return (z, z)

    def one(self) -> ExtTarget:
        return (self.b.one(), self.b.zero())

    def add_virtual_ext(self) -> ExtTarget:
        return (self.b.add_virtual_target(), self.b.add_virtual_target())

    # -- ring ops -------------------------------------------------------------
    def add(self, a: ExtTarget, b: ExtTarget) -> ExtTarget:
        return (self.b.add(a[0], b[0]), self.b.add(a[1], b[1]))

    def sub(self, a: ExtTarget, b: ExtTarget) -> ExtTarget:
        return (self.b.sub(a[0], b[0]), self.b.sub(a[1], b[1]))

    def mul(self, a: ExtTarget, b: ExtTarget) -> ExtTarget:
        """4 arithmetic ops: c0 = a0 b0 + 7 a1 b1; c1 = a0 b1 + a1 b0."""
        bb = self.b
        t00 = bb.mul(a[0], b[0])
        c0 = bb.arithmetic(W_EXT, 1, a[1], b[1], t00)
        t01 = bb.mul(a[0], b[1])
        c1 = bb.arithmetic(1, 1, a[1], b[0], t01)
        return (c0, c1)

    def mul_base(self, a: ExtTarget, t: Target) -> ExtTarget:
        return (self.b.mul(a[0], t), self.b.mul(a[1], t))

    def cmul(self, c: int, a: ExtTarget) -> ExtTarget:
        return (self.b.mul_const(c, a[0]), self.b.mul_const(c, a[1]))

    def cadd(self, c: int, a: ExtTarget) -> ExtTarget:
        # a0 + c without a constant-gate slot: 1*a0*1 + c*1
        return (self.b.arithmetic(1, c, a[0], self.b.one(), self.b.one()),
                a[1])

    def square(self, a: ExtTarget) -> ExtTarget:
        return self.mul(a, a)

    def exp_pow2(self, a: ExtTarget, log_e: int) -> ExtTarget:
        for _ in range(log_e):
            a = self.square(a)
        return a

    def inverse(self, a: ExtTarget) -> ExtTarget:
        """Witness-hinted inverse: prover supplies 1/a, circuit checks
        a * inv == 1 (also proves a != 0)."""
        inv = self.add_virtual_ext()
        bb = self.b

        def gen(pw, _a=a, _inv=inv):
            a0, a1 = pw.get(_a[0]), pw.get(_a[1])
            if a0 is None or a1 is None or pw.get(_inv[0]) is not None:
                return
            i0, i1 = gl64_ext.h_inverse((a0, a1))
            pw.set(_inv[0], i0)
            pw.set(_inv[1], i1)

        bb.add_generator(gen, deps=[_a0 for _a0 in a])
        prod = self.mul(a, inv)
        bb.connect(prod[0], bb.one())
        bb.connect(prod[1], bb.zero())
        return inv

    def div(self, a: ExtTarget, b: ExtTarget) -> ExtTarget:
        return self.mul(a, self.inverse(b))

    def connect(self, a: ExtTarget, b: ExtTarget):
        self.b.connect(a[0], b[0])
        self.b.connect(a[1], b[1])

    def select(self, bit: Target, x: ExtTarget, y: ExtTarget) -> ExtTarget:
        """bit ? x : y (bit assumed boolean-constrained)."""
        return (select_base(self.b, bit, x[0], y[0]),
                select_base(self.b, bit, x[1], y[1]))


class CircuitExtAlg:
    """Algebra over ExtTargets — plugs gate.eval_alg into the recursive
    verifier so each child gate's constraints are re-evaluated in-circuit at
    zeta (plonky2 `eval_unfiltered_circuit` role)."""

    def __init__(self, ext: ExtGadgets):
        self.e = ext
        self.add = ext.add
        self.sub = ext.sub
        self.mul = ext.mul
        self.cmul = lambda c, x: ext.cmul(c, x)
        self.cadd = lambda c, x: ext.cadd(c, x)
        self.const_like = lambda c, like: ext.const_ext((c % P, 0))


# ---------------------------------------------------------------------------
# Base-field helpers
# ---------------------------------------------------------------------------

def select_base(b: CircuitBuilder, bit: Target, x: Target,
                y: Target) -> Target:
    """bit ? x : y = y + bit * (x - y)."""
    d = b.sub(x, y)
    return b.mul_add(bit, d, y)


def base_inverse(b: CircuitBuilder, x: Target) -> Target:
    """Witness-hinted 1/x with x * inv == 1 constraint."""
    inv = b.add_virtual_target()

    def gen(pw, _x=x, _inv=inv):
        v = pw.get(_x)
        if v is None or pw.get(_inv) is not None:
            return
        pw.set(_inv, pow(v, P - 2, P))

    b.add_generator(gen, deps=[x])
    b.connect(b.mul(x, inv), b.one())
    return inv


def split_le_16(b: CircuitBuilder, limb: Target) -> list:
    """One BaseSum(16) row: limb -> 16 routable little-endian bits."""
    row = b.add_gate(BaseSumGate(16), ())
    b.connect(limb, row_wire(row, 0))
    return [row_wire(row, 1 + i) for i in range(16)]


def row_wire(row: int, col: int):
    from .circuit import Wire
    return Wire(row, col)


def split_le_64(b: CircuitBuilder, x: Target, *,
                canonical: bool = False) -> list:
    """Decompose x into 64 little-endian bits via 4 BaseSum(16) limbs.

    With canonical=True, additionally constrains the decomposition to be the
    canonical representative (< p): since p = 2^64 - 2^32 + 1, x >= p iff
    bits[32..64] are all 1 AND low32 != 0, so we require
    prod(bits[32..64]) * low32 == 0. Needed whenever the bits feed
    Fiat-Shamir index derivation (a prover free to pick x or x+p could
    steer FRI query indices).
    """
    limbs = [b.add_virtual_target() for _ in range(4)]

    def gen(pw, _x=x, _limbs=limbs):
        v = pw.get(_x)
        if v is None or pw.get(_limbs[0]) is not None:
            return
        for i, lt in enumerate(_limbs):
            pw.set(lt, (v >> (16 * i)) & 0xFFFF)

    b.add_generator(gen, deps=[x])
    bits = []
    for lt in limbs:
        bits.extend(split_le_16(b, lt))
    # x == sum limbs * 2^(16 i)
    acc = limbs[0]
    for i in range(1, 4):
        acc = b.arithmetic(pow(2, 16 * i, P), 1, limbs[i], b.one(), acc)
    b.connect(acc, x)
    if canonical:
        prod = bits[32]
        for i in range(33, 64):
            prod = b.mul(prod, bits[i])
        low32 = b.arithmetic(1 << 16, 1, limbs[1], b.one(), limbs[0])
        b.assert_zero(b.mul(prod, low32))
    return bits


def exp_from_bits_const_base(b: CircuitBuilder, base: int, bits: list,
                             scale: int = 1) -> Target:
    """scale * base^(sum bits_i 2^i) for a compile-time base: product of
    per-bit factors (1 + bit_i (base^{2^i} - 1))."""
    acc = None
    cur = base % P
    for bit in bits:
        # factor = 1 + bit*(cur - 1)
        f = b.arithmetic((cur - 1) % P, 1, bit, b.one(), b.one())
        acc = f if acc is None else b.mul(acc, f)
        cur = (cur * cur) % P
    if acc is None:
        acc = b.one()
    if scale != 1:
        acc = b.mul_const(scale, acc)
    return acc


def select_hash_by_bits(b: CircuitBuilder, bits: list,
                        entries: list) -> list:
    """entries: 2^len(bits) digests (each 4 targets); returns
    entries[sum bits_i 2^i] via a binary select tree."""
    assert len(entries) == 1 << len(bits)
    cur = entries
    for bit in bits:
        nxt = []
        for i in range(0, len(cur), 2):
            nxt.append([select_base(b, bit, cur[i + 1][j], cur[i][j])
                        for j in range(4)])
        cur = nxt
    assert len(cur) == 1
    return cur[0]


def verify_merkle_proof_gadget(b: CircuitBuilder, leaf_digest: list,
                               index_bits: list, siblings: list,
                               cap_entries: list):
    """In-circuit twin of merkle.h_verify_merkle_proof: walk the path using
    index bits for ordering, then connect to the cap entry selected by the
    remaining bits. len(index_bits) == len(siblings) + log2(len(cap))."""
    cur = list(leaf_digest)
    depth = len(siblings)
    for lvl, sib in enumerate(siblings):
        bit = index_bits[lvl]
        left = [select_base(b, bit, sib[j], cur[j]) for j in range(4)]
        right = [select_base(b, bit, cur[j], sib[j]) for j in range(4)]
        cur = b.hash_two_to_one(left, right)
    cap_bits = index_bits[depth:]
    assert len(cap_entries) == 1 << len(cap_bits)
    want = (cap_entries[0] if not cap_bits
            else select_hash_by_bits(b, cap_bits, cap_entries))
    for j in range(4):
        b.connect(cur[j], want[j])


# ---------------------------------------------------------------------------
# Horner reductions (ReducingGate-backed)
# ---------------------------------------------------------------------------

def _reducing_steps(b: CircuitBuilder, ext_values: bool) -> int:
    r = b.config.num_routed_wires
    return (r - 6) // 2 if ext_values else (r - 6)


def reduce_with_powers(b: CircuitBuilder, ext: ExtGadgets, values: list,
                       alpha: ExtTarget) -> ExtTarget:
    """sum_i alpha^i * values[i] for base-target values, as chained
    ReducingGate rows (Horner from the top; zero-padded at the high end)."""
    k = _reducing_steps(b, False)
    gate = ReducingGate(k)
    seq = list(reversed([v for v in values]))
    pad = (-len(seq)) % k
    seq = [b.zero()] * pad + seq
    acc = ext.zero()
    for c0 in range(0, len(seq), k):
        row = b.add_gate(gate, ())
        b.connect(acc[0], row_wire(row, gate.COL_ACC_IN))
        b.connect(acc[1], row_wire(row, gate.COL_ACC_IN + 1))
        b.connect(alpha[0], row_wire(row, gate.COL_ALPHA))
        b.connect(alpha[1], row_wire(row, gate.COL_ALPHA + 1))
        for i, v in enumerate(seq[c0:c0 + k]):
            b.connect(v, row_wire(row, gate.COL_VALS + i))
        acc = (row_wire(row, gate.COL_ACC_OUT),
               row_wire(row, gate.COL_ACC_OUT + 1))
    return acc


def reduce_with_powers_ext(b: CircuitBuilder, ext: ExtGadgets, values: list,
                           alpha: ExtTarget) -> ExtTarget:
    """sum_i alpha^i * values[i] for ExtTarget values."""
    k = _reducing_steps(b, True)
    gate = ReducingExtGate(k)
    seq = list(reversed(list(values)))
    pad = (-len(seq)) % k
    seq = [ext.zero()] * pad + seq
    acc = ext.zero()
    for c0 in range(0, len(seq), k):
        row = b.add_gate(gate, ())
        b.connect(acc[0], row_wire(row, gate.COL_ACC_IN))
        b.connect(acc[1], row_wire(row, gate.COL_ACC_IN + 1))
        b.connect(alpha[0], row_wire(row, gate.COL_ALPHA))
        b.connect(alpha[1], row_wire(row, gate.COL_ALPHA + 1))
        for i, v in enumerate(seq[c0:c0 + k]):
            b.connect(v[0], row_wire(row, gate.COL_VALS + 2 * i))
            b.connect(v[1], row_wire(row, gate.COL_VALS + 2 * i + 1))
        acc = (row_wire(row, gate.COL_ACC_OUT),
               row_wire(row, gate.COL_ACC_OUT + 1))
    return acc


def eval_poly_ext_horner(b: CircuitBuilder, ext: ExtGadgets, coeffs: list,
                         x: Target) -> ExtTarget:
    """Evaluate an ext-coefficient polynomial at a base point x:
    reduce coeffs (highest power first is handled by the reduction's
    reversal) with alpha = x."""
    return reduce_with_powers_ext(b, ext, coeffs, ext.ext(x))
