"""Gate library: per-row polynomial constraints, written once against the
algebra interface (snark/algebra.py) and evaluated over the LDE domain on
int64 tensors (the prover's quotient pass) and at one extension point
(the host verifier).

Counterpart of the reference's ``snark/gates.py``: the same gates, keys,
wire layouts, constraints and witness generators (plonky2's
`eval_unfiltered / eval_unfiltered_base_batch` pair; gate list pinned by
`add_city_common_gates`, city_common_circuit/src/builder/pad_circuit.rs).

Wire layout conventions are per-gate, documented on each class.
"""

from __future__ import annotations

from ..core import gl64, gl64_ext
from .algebra import HostExtAlg, TorchAlg, lift_host

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

    def eval_torch_vec(self, wires, constants, pi_hash):
        """wires/constants: int64 tensors over the LDE domain ((M,) or
        (B, M)); pi_hash: 4 tensors that broadcast against them (0-d, or
        (B, 1) columns, from algebra.lift_torch). Returns the constraint
        tensors in eval_alg order."""
        return self.eval_alg(wires, constants, pi_hash, TorchAlg)

    # witness generation: fill this row's derived wires
    def generate(self, row, get, set_wire, constants=None):
        """get(col)->int reads an input wire; set_wire(col, value) writes."""
        pass

    def sub_generators(self):
        """[(dep_cols | None, fn(row, get, set_wire, constants))] — the
        scheduler runs fn once when every dep col has a value; None deps
        fall back to the fixpoint loop. Default: the whole-row generate()
        as one dep-less node (gates without generators contribute none)."""
        if type(self).generate is Gate.generate:
            return []
        return [(None, self.generate)]


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

    def generate(self, row, get, set_wire, constants=None):
        c0, c1 = constants[0], constants[1]
        for t in range(self._num_ops):
            a, b, d = get(4 * t), get(4 * t + 1), get(4 * t + 2)
            if a is None or b is None or d is None:
                continue
            set_wire(4 * t + 3, (c0 * a * b + c1 * d) % P)

    def sub_generators(self):
        # the same for every row of this gate: made once
        if self._sub_generators is None:
            def op_gen(t):
                def fn(row, get, set_wire, constants=None, _t=t):
                    c0, c1 = constants[0], constants[1]
                    a, b, d = get(4 * _t), get(4 * _t + 1), get(4 * _t + 2)
                    set_wire(4 * _t + 3, (c0 * a * b + c1 * d) % P)
                return fn
            self._sub_generators = [([4 * t, 4 * t + 1, 4 * t + 2],
                                     op_gen(t))
                                    for t in range(self._num_ops)]
        return self._sub_generators


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

    def generate(self, row, get, set_wire, constants=None):
        for t in range(self._n):
            set_wire(t, constants[t] % P)

    def sub_generators(self):
        return [([], self.generate)]


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

    def generate(self, row, get, set_wire, constants=None):
        v = get(0)
        if v is None:
            return
        for i in range(self.num_bits):
            set_wire(1 + i, (v >> i) & 1)

    def sub_generators(self):
        return [([0], self.generate)]


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

    def generate(self, row, get, set_wire, constants=None):
        acc = (get(self.COL_ACC_IN), get(self.COL_ACC_IN + 1))
        alpha = (get(self.COL_ALPHA), get(self.COL_ALPHA + 1))
        if None in acc or None in alpha:
            return
        for i in range(self.num_steps):
            v = get(self.COL_VALS + i)
            if v is None:
                return
            acc = gl64_ext.h_mul(acc, alpha)
            acc = ((acc[0] + v) % P, acc[1])
            if i < self.num_steps - 1:
                c = self.col_intermediate(i)
                set_wire(c, acc[0])
                set_wire(c + 1, acc[1])
            else:
                set_wire(self.COL_ACC_OUT, acc[0])
                set_wire(self.COL_ACC_OUT + 1, acc[1])

    def sub_generators(self):
        deps = [self.COL_ACC_IN, self.COL_ACC_IN + 1, self.COL_ALPHA,
                self.COL_ALPHA + 1] + \
            [self.COL_VALS + i for i in range(self.num_steps)]
        return [(deps, self.generate)]


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

    def generate(self, row, get, set_wire, constants=None):
        acc = (get(self.COL_ACC_IN), get(self.COL_ACC_IN + 1))
        alpha = (get(self.COL_ALPHA), get(self.COL_ALPHA + 1))
        if None in acc or None in alpha:
            return
        for i in range(self.num_steps):
            v = (get(self.COL_VALS + 2 * i), get(self.COL_VALS + 2 * i + 1))
            if None in v:
                return
            acc = gl64_ext.h_add(gl64_ext.h_mul(acc, alpha), v)
            if i < self.num_steps - 1:
                c = self.col_intermediate(i)
                set_wire(c, acc[0])
                set_wire(c + 1, acc[1])
            else:
                set_wire(self.COL_ACC_OUT, acc[0])
                set_wire(self.COL_ACC_OUT + 1, acc[1])

    def sub_generators(self):
        deps = [self.COL_ACC_IN, self.COL_ACC_IN + 1, self.COL_ALPHA,
                self.COL_ALPHA + 1] + \
            [self.COL_VALS + i for i in range(2 * self.num_steps)]
        return [(deps, self.generate)]


def gate_from_key(key: str) -> Gate:
    """Reconstruct a gate object from its stable key (fixture/corpus
    deserialization — e.g. the sighash whitelist corpus records the shared
    declared gate set as keys)."""
    from .gate_poseidon import PoseidonGate
    if key == "public_input":
        return PublicInputGate()
    if key == "poseidon":
        return PoseidonGate()
    name, _, arg = key.partition("<")
    n = int(arg.rstrip(">"))
    ctor = {"arithmetic": ArithmeticGate, "constant": ConstantGate,
            "base_sum": BaseSumGate, "reducing": ReducingGate,
            "reducing_ext": ReducingExtGate}.get(name)
    if ctor is None:
        raise KeyError(f"unknown gate key {key!r}")
    return ctor(n)
