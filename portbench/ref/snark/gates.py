"""Gate library: per-row polynomial constraints, written once against the
algebra interface (snark/algebra.py) and evaluated at one extension point
(the host verifier) and in-circuit (the recursion gadget).

Counterpart of the port's ``snark/gates.py``: the same gates, keys, wire
layouts and constraints, without the witness generators (plonky2's
`eval_unfiltered / eval_unfiltered_base_batch` pair; gate list pinned by
`add_city_common_gates`, city_common_circuit/src/builder/pad_circuit.rs).

Wire layout conventions are per-gate, documented on each class.
"""

from __future__ import annotations

from ..core import gl64, gl64_ext
from .algebra import HostExtAlg, lift_host

P = gl64.P
W_EXT = gl64_ext.W                  # X^2 = 7


class Gate:
    """Base: a gate occupies one row; constraints reference that row's wires
    and constant columns only."""

    #: unique stable key for selector grouping / serialization
    key: str
    num_constraints: int
    degree: int                     # max constraint degree (in trace polys)

    def num_ops(self) -> int:
        return 1

    def eval_alg(self, wires, constants, pi_hash, alg):
        """wires/constants/pi_hash: lists of algebra elements. Returns the
        list of constraint values (len == num_constraints)."""
        raise NotImplementedError

    def eval_host(self, wires, constants, pi_hash):
        """wires/constants: ext (int, int) tuples; pi_hash: 4 base ints."""
        return self.eval_alg(wires, constants,
                             [lift_host(int(v)) for v in pi_hash], HostExtAlg)

    # witness generation: fill this row's derived wires
class ArithmeticGate(Gate):
    """num_ops independent ops: out = c0 * a * b + c1 * d, with shared
    per-row constants (c0, c1). Wires per op t: [4t]=a, [4t+1]=b, [4t+2]=d,
    [4t+3]=out. (plonky2 ArithmeticGate twin.)"""

    degree = 3

    def __init__(self, num_ops: int):
        self._num_ops = num_ops
        self.key = f"arithmetic<{num_ops}>"
        self.num_constraints = num_ops
        self._sub_generators = None

    def num_ops(self) -> int:
        return self._num_ops

    def eval_alg(self, wires, constants, pi_hash, alg):
        c0, c1 = constants[0], constants[1]
        out = []
        for t in range(self._num_ops):
            a, b, d, o = (wires[4 * t], wires[4 * t + 1],
                          wires[4 * t + 2], wires[4 * t + 3])
            term = alg.add(alg.mul(c0, alg.mul(a, b)), alg.mul(c1, d))
            out.append(alg.sub(term, o))
        return out

class ConstantGate(Gate):
    """wire[t] == constant column t, for t < num_consts (routes circuit
    constants into the copy-constraint graph). plonky2 ConstantGate twin."""

    degree = 1

    def __init__(self, num_consts: int):
        self._n = num_consts
        self.key = f"constant<{num_consts}>"
        self.num_constraints = num_consts

    def num_ops(self) -> int:
        return self._n

    def eval_alg(self, wires, constants, pi_hash, alg):
        return [alg.sub(wires[t], constants[t]) for t in range(self._n)]

class BaseSumGate(Gate):
    """Binary decomposition: wire[0] == sum_i wire[1+i] * 2^i, each wire[1+i]
    binary. The range-check workhorse (plonky2 BaseSumGate<2> twin; the
    reference's u32 RangeCheckGate / ComparisonGate balance checks reduce to
    this — SURVEY.md §2.2 u32 custom gates)."""

    degree = 2

    def __init__(self, num_bits: int):
        self.num_bits = num_bits
        self.key = f"base_sum<{num_bits}>"
        self.num_constraints = 1 + num_bits

    def eval_alg(self, wires, constants, pi_hash, alg):
        acc = alg.cmul(0, wires[0])
        for i in range(self.num_bits):
            acc = alg.add(acc, alg.cmul(pow(2, i, P), wires[1 + i]))
        out = [alg.sub(acc, wires[0])]
        for i in range(self.num_bits):
            b = wires[1 + i]
            out.append(alg.mul(b, alg.cadd(P - 1, b)))
        return out

class PublicInputGate(Gate):
    """Wires 0..3 must equal the public-inputs hash vector (the verifier
    recomputes it from the claimed public inputs and substitutes it here).
    plonky2 PublicInputGate twin."""

    key = "public_input"
    degree = 1
    num_constraints = 4

    def eval_alg(self, wires, constants, pi_hash, alg):
        return [alg.sub(wires[i], pi_hash[i]) for i in range(4)]


class ReducingGate(Gate):
    """k-step Horner reduction with base-field values and an extension
    accumulator: acc := acc * alpha + v_i, for i = 0..k-1 in wire order.

    One row replaces k extension mul-adds — the workhorse of the in-circuit
    FRI batch-opening sums (reference: plonky2 ReducingGate(43) pinned into
    every city-rollup circuit, pad_circuit.rs:25-56).

    Routed wires: [0..2) acc_in, [2..4) acc_out, [4..6) alpha (ext),
    [6..6+k) values (base). Unrouted: [6+k..) intermediate accumulators
    (k-1 ext pairs).
    """

    degree = 2

    def __init__(self, num_steps: int):
        self.num_steps = num_steps
        self.key = f"reducing<{num_steps}>"
        self.num_constraints = 2 * num_steps

    COL_ACC_IN = 0
    COL_ACC_OUT = 2
    COL_ALPHA = 4
    COL_VALS = 6

    def col_intermediate(self, i: int) -> int:
        return self.COL_VALS + self.num_steps + 2 * i

    def num_wires(self) -> int:
        return self.COL_VALS + self.num_steps + 2 * (self.num_steps - 1)

    def num_routed(self) -> int:
        return self.COL_VALS + self.num_steps

    def _acc(self, wires, i: int):
        """(a0, a1) wires of accumulator state i (0 = acc_in, k = acc_out)."""
        if i == 0:
            return wires[self.COL_ACC_IN], wires[self.COL_ACC_IN + 1]
        if i == self.num_steps:
            return wires[self.COL_ACC_OUT], wires[self.COL_ACC_OUT + 1]
        c = self.col_intermediate(i - 1)
        return wires[c], wires[c + 1]

    def eval_alg(self, wires, constants, pi_hash, alg):
        al0, al1 = wires[self.COL_ALPHA], wires[self.COL_ALPHA + 1]
        cons = []
        for i in range(self.num_steps):
            a0, a1 = self._acc(wires, i)
            n0, n1 = self._acc(wires, i + 1)
            v = wires[self.COL_VALS + i]
            c0 = alg.add(alg.add(alg.mul(a0, al0),
                                 alg.cmul(W_EXT, alg.mul(a1, al1))), v)
            c1 = alg.add(alg.mul(a0, al1), alg.mul(a1, al0))
            cons.append(alg.sub(c0, n0))
            cons.append(alg.sub(c1, n1))
        return cons

class ReducingExtGate(Gate):
    """Like ReducingGate but with extension-field values:
    acc := acc * alpha + v_i, v_i ext. Routed: acc_in(2), acc_out(2),
    alpha(2), values (2k). (plonky2 ReducingExtensionGate(32) twin.)"""

    degree = 2

    def __init__(self, num_steps: int):
        self.num_steps = num_steps
        self.key = f"reducing_ext<{num_steps}>"
        self.num_constraints = 2 * num_steps

    COL_ACC_IN = 0
    COL_ACC_OUT = 2
    COL_ALPHA = 4
    COL_VALS = 6

    def col_intermediate(self, i: int) -> int:
        return self.COL_VALS + 2 * self.num_steps + 2 * i

    def num_wires(self) -> int:
        return self.COL_VALS + 2 * self.num_steps + 2 * (self.num_steps - 1)

    def num_routed(self) -> int:
        return self.COL_VALS + 2 * self.num_steps

    def _acc(self, wires, i: int):
        if i == 0:
            return wires[self.COL_ACC_IN], wires[self.COL_ACC_IN + 1]
        if i == self.num_steps:
            return wires[self.COL_ACC_OUT], wires[self.COL_ACC_OUT + 1]
        c = self.col_intermediate(i - 1)
        return wires[c], wires[c + 1]

    def eval_alg(self, wires, constants, pi_hash, alg):
        al0, al1 = wires[self.COL_ALPHA], wires[self.COL_ALPHA + 1]
        cons = []
        for i in range(self.num_steps):
            a0, a1 = self._acc(wires, i)
            n0, n1 = self._acc(wires, i + 1)
            v0 = wires[self.COL_VALS + 2 * i]
            v1 = wires[self.COL_VALS + 2 * i + 1]
            c0 = alg.add(alg.add(alg.mul(a0, al0),
                                 alg.cmul(W_EXT, alg.mul(a1, al1))), v0)
            c1 = alg.add(alg.add(alg.mul(a0, al1), alg.mul(a1, al0)), v1)
            cons.append(alg.sub(c0, n0))
            cons.append(alg.sub(c1, n1))
        return cons

