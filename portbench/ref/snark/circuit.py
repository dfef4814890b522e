"""CircuitBuilder and circuit data: rows of gates, routed-wire copy
constraints, preprocessing (selectors/constants/sigmas) committed as one
Merkle cap.

Counterpart of the reference's ``snark/circuit.py`` (plonky2
`plonk::circuit_builder::CircuitBuilder` + `circuit_data::{CircuitData,
CommonCircuitData, VerifierOnlyCircuitData}`): the same builder, so the
same builder function gives the same rows, sigmas, selector groups,
constants/sigmas cap and circuit digest. Building and witness generation
are host Python; the preprocessing (interpolation, coset LDE, Merkle
commitment) runs on the circuit's device: CUDA unless ``build`` is given
``device="cpu"``.

Public inputs: up to 4 are routed directly into the PublicInputGate's four
wires; more are Poseidon-hashed in-circuit and the digest routed there.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from .. import convert
from .. import device as _device
from ..core import gl64, merkle, ntt, poseidon_host
from .config import CircuitConfig, UNUSED_SELECTOR
from .gates import ArithmeticGate, ConstantGate, Gate, PublicInputGate

P = gl64.P


# ---------------------------------------------------------------------------
# Targets
# ---------------------------------------------------------------------------

# Targets are named tuples: the witness scheduler and the union-find hash
# and compare millions of them, which a tuple does in C. The hash of each
# is the reference's (its dataclasses hash the tuple of their fields).
class Wire(NamedTuple):
    row: int
    col: int


class VirtualTarget(NamedTuple):
    idx: int


Target = Union[Wire, VirtualTarget]


class _UnionFind:
    def __init__(self):
        self.parent: dict = {}

    def find(self, x):
        # iterative with full path compression (recursion would overflow on
        # the multi-thousand-element classes a recursive verifier creates)
        parent = self.parent
        root = x
        while True:
            p = parent.get(root, root)
            if p == root:
                break
            root = p
        while x != root:
            nxt = parent[x]
            parent[x] = root
            x = nxt
        return root

    def union(self, a, b):
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[ra] = rb


# ---------------------------------------------------------------------------
# Circuit data
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class GateInstance:
    gate: Gate
    constants: tuple            # per-row constant column values


@dataclasses.dataclass
class CommonData:
    config: CircuitConfig
    log_n: int
    gates: list                 # unique Gate objects, global index = gate id
    selector_groups: list       # list[list[int]] of gate ids
    num_public_inputs: int

    @property
    def n(self) -> int:
        return 1 << self.log_n

    @property
    def num_sel_cols(self) -> int:
        return len(self.selector_groups)

    @property
    def k_is(self) -> list[int]:
        """Coset representatives for routed columns: 7^i."""
        g = gl64.MULTIPLICATIVE_GROUP_GENERATOR
        out, cur = [], 1
        for _ in range(self.config.num_routed_wires):
            out.append(cur)
            cur = (cur * g) % P
        return out

    def gate_group(self, gate_id: int) -> int:
        for gi, group in enumerate(self.selector_groups):
            if gate_id in group:
                return gi
        raise KeyError(gate_id)

    def filter_terms(self, gate_id: int) -> list[int]:
        """(s - t) factors of gate_id's selector filter: UNUSED + the other
        gate ids in its group."""
        group = self.selector_groups[self.gate_group(gate_id)]
        return [UNUSED_SELECTOR] + [t for t in group if t != gate_id]


def compute_selector_groups(gates: list, cfg) -> list[list[int]]:
    """Greedy selector-group packing: a group of k gates with max degree d
    costs (k+1)+d <= max_constraint_degree per filtered constraint."""
    selector_groups: list[list[int]] = []
    cur_group: list[int] = []
    cur_maxdeg = 0
    for gid, g in enumerate(gates):
        d = max(cur_maxdeg, g.degree)
        if cur_group and (len(cur_group) + 1) + d > \
                cfg.max_constraint_degree:
            selector_groups.append(cur_group)
            cur_group, cur_maxdeg = [], 0
        cur_group.append(gid)
        cur_maxdeg = max(cur_maxdeg, g.degree)
    if cur_group:
        selector_groups.append(cur_group)
    return selector_groups


def common_shape_key(common: CommonData) -> tuple:
    """Structural identity of a proof shape: two circuits with equal keys
    produce interchangeable proofs (plonky2's shared-CommonCircuitData
    invariant — reference pad_circuit.rs:25-56 pins the gate set and
    degree so sibling circuits share one shape)."""
    return (common.config, common.log_n,
            tuple(g.key for g in common.gates),
            tuple(tuple(gr) for gr in common.selector_groups),
            common.num_public_inputs)


@dataclasses.dataclass
class VerifierData:
    constants_sigmas_cap: np.ndarray    # (2^cap, 4) uint64
    circuit_digest: tuple               # 4 ints


class ProverData:
    """Prover-side circuit data. The expensive preprocessing (coefficient
    NTTs, coset LDE, Merkle commitment of the constants/sigmas) is lazy and
    runs on the circuit's device when a proof (or the verifier cap/digest)
    is first needed: circuit building for witness checks and shape probing
    stays host-only."""

    def __init__(self, rows, row_gate_id, sigmas, const_sigma_values,
                 subgroup, pi_targets, log_n, rate_bits, cap_height,
                 wire_classes, device=None):
        self.rows = rows                          # GateInstance | None
        self.row_gate_id = row_gate_id
        # (class index of each routed wire (R, n), class roots): the copy
        # classes, fixed at build, that generate_witness fills the routed
        # wires from
        self.wire_classes = wire_classes
        self.sigmas = sigmas                      # (R, n) uint64
        self.const_sigma_values = const_sigma_values   # (S, n)
        self.subgroup = subgroup                  # g^row table (n,)
        self.pi_targets = pi_targets
        self._log_n = log_n
        self._rate_bits = rate_bits
        self._cap_height = cap_height
        self._device_arg = device
        self._device = None
        self._coeffs = None
        self._ldes = None
        self._tree = None
        self._tables = None

    @property
    def device(self) -> torch.device:
        """Where the proofs of this circuit run (resolved at first use)."""
        if self._device is None:
            self._device = _device(self._device_arg)
        return self._device

    def _preprocess(self):
        if self._tree is None:
            coeffs, ldes = interp_and_lde(
                convert.from_u64(self.const_sigma_values, self.device),
                self._log_n, self._rate_bits)
            self._coeffs, self._ldes = coeffs, ldes
            self._tree = merkle.MerkleTree.from_polys(
                ldes, cap_height=min(self._cap_height,
                                     self._log_n + self._rate_bits))

    @property
    def tree(self) -> merkle.MerkleTree:
        self._preprocess()
        return self._tree

class CircuitData:
    """common + prover + (lazily derived) verifier data."""

    def __init__(self, common: CommonData, prover: ProverData):
        self.common = common
        self.prover = prover
        self._verifier = None

    @property
    def verifier(self) -> VerifierData:
        if self._verifier is None:
            cfg = self.common.config
            cap = self.prover.tree.cap_u64()
            digest = tuple(poseidon_host.hash_no_pad(
                [int(x) for x in cap.reshape(-1)] +
                [self.common.log_n, cfg.num_routed_wires,
                 cfg.num_constants, self.common.num_sel_cols]))
            self._verifier = VerifierData(constants_sigmas_cap=cap,
                                          circuit_digest=digest)
        return self._verifier


# ---------------------------------------------------------------------------
# Witness
# ---------------------------------------------------------------------------

class PartialWitness:
    """Target -> value map over copy-constraint classes. Newly assigned
    class roots are journaled so the witness scheduler can wake dependent
    generators without a global fixpoint sweep."""

    def __init__(self, uf: _UnionFind):
        self._uf = uf
        self._vals: dict = {}
        self.journal: list = []

    def set(self, t: Target, v: int):
        v = v % P
        r = self._uf.find(t)
        old = self._vals.get(r)
        if old is not None:
            if old != v:
                raise ValueError(f"witness conflict at {t}: {old} vs {v}")
            return
        self._vals[r] = v
        self.journal.append(r)

    def get(self, t: Target) -> Optional[int]:
        return self._vals.get(self._uf.find(t))


# ---------------------------------------------------------------------------
# Builder
# ---------------------------------------------------------------------------

class CircuitBuilder:
    def __init__(self, config: CircuitConfig | None = None):
        self.config = config or CircuitConfig()
        self.rows: list[GateInstance | None] = []
        self.uf = _UnionFind()
        self.public_inputs: list[Target] = []
        self._virtual_cnt = 0
        self._arith_slots: dict = {}     # (c0, c1) -> (row, next_op)
        self._const_slot: tuple | None = None
        self._const_cache: dict = {}
        self._zero = None
        self._one = None
        self._arith_gate = ArithmeticGate(
            self.config.num_routed_wires // 4)
        self._const_gate = ConstantGate(self.config.num_constants)
        self.generators: list = []
        self.declared_gates: list[Gate] = []
        self._built = False

    # -- shared-shape machinery (reference: add_city_common_gates +
    #    pad_circuit_degree, city_common_circuit/src/builder/pad_circuit.rs) --
    def declare_gate(self, gate: Gate):
        """Pin `gate` into the circuit's gate set (and selector groups) even
        if no row instantiates it. Circuits declaring the same gate list in
        the same order and built with the same `min_log_n` share one
        CommonData — the invariant that lets one aggregation circuit verify
        any sibling proof (SURVEY.md §2.2 gate-set padding)."""
        if all(g.key != gate.key for g in self.declared_gates):
            self.declared_gates.append(gate)

    def declare_gates(self, gates):
        for g in gates:
            self.declare_gate(g)

    def add_generator(self, fn, deps: list | None = None):
        """Register a custom witness generator fn(pw) (plonky2
        iop::generator SimpleGenerator role). fn reads targets via pw.get
        (None = not yet known) and writes via pw.set.

        `deps`: the input targets fn needs before it can fully run. With
        deps the scheduler runs fn exactly once, as soon as all deps have
        values; without deps fn joins the (slow) fallback fixpoint loop."""
        self.generators.append((fn, deps))

    # -- rows ------------------------------------------------------------
    def add_gate(self, gate: Gate, constants: tuple = ()) -> int:
        consts = tuple(int(c) % P for c in constants)
        consts = consts + (0,) * (self.config.num_constants - len(consts))
        self.rows.append(GateInstance(gate, consts))
        return len(self.rows) - 1

    # -- targets -----------------------------------------------------------
    def add_virtual_target(self) -> VirtualTarget:
        self._virtual_cnt += 1
        return VirtualTarget(self._virtual_cnt - 1)

    def add_virtual_targets(self, n: int) -> list[VirtualTarget]:
        return [self.add_virtual_target() for _ in range(n)]

    def connect(self, a: Target, b: Target):
        for t in (a, b):
            if isinstance(t, Wire):
                assert t.col < self.config.num_routed_wires, \
                    f"cannot route non-routed wire column {t.col}"
        self.uf.union(a, b)

    def register_public_input(self, t: Target):
        self.public_inputs.append(t)

    def register_public_inputs(self, ts):
        for t in ts:
            self.register_public_input(t)

    # -- constants -----------------------------------------------------------
    def constant(self, v: int) -> Target:
        v = int(v) % P
        if v in self._const_cache:
            return self._const_cache[v]
        if self._const_slot is None or self._const_slot[1] >= \
                self.config.num_constants:
            # new constant row; constants filled as slots are claimed
            row = self.add_gate(self._const_gate, ())
            self._const_slot = (row, 0)
        row, slot = self._const_slot
        inst = self.rows[row]
        consts = list(inst.constants)
        consts[slot] = v
        self.rows[row] = GateInstance(inst.gate, tuple(consts))
        self._const_slot = (row, slot + 1)
        t = Wire(row, slot)
        self._const_cache[v] = t
        return t

    def zero(self) -> Target:
        if self._zero is None:
            self._zero = self.constant(0)
        return self._zero

    def one(self) -> Target:
        if self._one is None:
            self._one = self.constant(1)
        return self._one

    # -- arithmetic -----------------------------------------------------------
    def arithmetic(self, c0: int, c1: int, a: Target, b: Target,
                   d: Target) -> Target:
        """out = c0*a*b + c1*d (allocates an op slot; rows with equal
        (c0, c1) are shared, like plonky2's batched ArithmeticGate)."""
        key = (int(c0) % P, int(c1) % P)
        slot = self._arith_slots.get(key)
        if slot is None or slot[1] >= self._arith_gate.num_ops():
            row = self.add_gate(self._arith_gate, key)
            slot = (row, 0)
        row, t = slot
        self._arith_slots[key] = (row, t + 1)
        wa, wb, wd, wout = (Wire(row, 4 * t), Wire(row, 4 * t + 1),
                            Wire(row, 4 * t + 2), Wire(row, 4 * t + 3))
        self.connect(a, wa)
        self.connect(b, wb)
        self.connect(d, wd)
        return wout

    def add(self, a, b):
        return self.arithmetic(1, 1, a, self.one(), b)

    def sub(self, a, b):
        return self.arithmetic(1, P - 1, a, self.one(), b)

    def mul(self, a, b):
        return self.arithmetic(1, 0, a, b, self.zero())

    def mul_add(self, a, b, d):
        return self.arithmetic(1, 1, a, b, d)

    def mul_const(self, k, a):
        return self.arithmetic(k, 0, a, self.one(), self.zero())

    def add_const(self, a, k):
        return self.arithmetic(1, 1, a, self.one(), self.constant(k))

    def square(self, a):
        return self.mul(a, a)

    def assert_equal(self, a, b):
        self.connect(a, b)

    def assert_zero(self, a):
        self.connect(a, self.zero())

    def exp_u64(self, base, e: int):
        """base^e for a compile-time exponent."""
        result = None
        cur = base
        while e > 0:
            if e & 1:
                result = cur if result is None else self.mul(result, cur)
            cur = self.square(cur)
            e >>= 1
        return self.one() if result is None else result

    # -- hashing (Poseidon in-circuit) -----------------------------------------
    def poseidon_permute(self, state: list) -> list:
        """Width-12 Poseidon permutation; one PoseidonGate row."""
        from .gate_poseidon import (COL_IN, COL_OUT, NUM_WIRES, W12,
                                    PoseidonGate)
        assert len(state) == W12
        assert self.config.num_wires >= NUM_WIRES, \
            "config.num_wires too small for PoseidonGate (need >= 142); " \
            "use CircuitConfig.poseidon_config()"
        if not hasattr(self, "_poseidon_gate"):
            self._poseidon_gate = PoseidonGate()
        row = self.add_gate(self._poseidon_gate, ())
        for i, t in enumerate(state):
            self.connect(t, Wire(row, COL_IN + i))
        return [Wire(row, COL_OUT + i) for i in range(W12)]

    def hash_n_to_m_no_pad(self, inputs: list, num_outputs: int) -> list:
        """Poseidon sponge, rate 8 / capacity 4, no padding (in-circuit twin
        of poseidon_host.hash_n_to_m_no_pad; plonky2 hash_n_to_hash_no_pad)."""
        rate = 8
        state = [self.zero()] * 12
        for c0 in range(0, len(inputs), rate):
            chunk = inputs[c0:c0 + rate]
            state = list(chunk) + state[len(chunk):]
            state = self.poseidon_permute(state)
        outputs = []
        while True:
            for t in state[:rate]:
                outputs.append(t)
                if len(outputs) == num_outputs:
                    return outputs
            state = self.poseidon_permute(state)

    def hash_n_to_hash_no_pad(self, inputs: list) -> list:
        return self.hash_n_to_m_no_pad(inputs, 4)

    def hash_two_to_one(self, left: list, right: list) -> list:
        """Merkle interior node: permute(left || right || 0^4)[:4]."""
        assert len(left) == 4 and len(right) == 4
        state = list(left) + list(right) + [self.zero()] * 4
        return self.poseidon_permute(state)[:4]

    def add_virtual_hash(self) -> list:
        return self.add_virtual_targets(4)

    def connect_hashes(self, a: list, b: list):
        for x, y in zip(a, b):
            self.connect(x, y)

    # -- range checks ----------------------------------------------------------
    def split_le(self, t: Target, num_bits: int) -> list:
        """Decompose t into num_bits little-endian bits (proving t < 2^bits).
        Bits are routable for num_bits <= num_routed_wires - 1."""
        from .gates import BaseSumGate
        assert num_bits + 1 <= self.config.num_wires
        row = self.add_gate(BaseSumGate(num_bits), ())
        self.connect(t, Wire(row, 0))
        return [Wire(row, 1 + i) for i in range(num_bits)]

    def range_check(self, t: Target, num_bits: int):
        """Assert t < 2^num_bits (bits stay unrouted)."""
        from .gates import BaseSumGate
        assert num_bits + 1 <= self.config.num_wires
        row = self.add_gate(BaseSumGate(num_bits), ())
        self.connect(t, Wire(row, 0))

    def assert_lte(self, a: Target, b: Target, num_bits: int = 32):
        """Assert a <= b for values known < 2^num_bits (reference
        ComparisonGate's balance-check role, SURVEY.md §2.2)."""
        self.range_check(self.sub(b, a), num_bits)

    def _copy_classes(self, R: int, n: int) -> tuple[np.ndarray, list]:
        """((R, n) class index of each routed wire, -1 where the wire was
        never joined; the root target of each class). Only the targets the
        union-find joined are walked, not all R x n wires."""
        find = self.uf.find
        class_roots: list = []
        index: dict = {}
        wire_class = np.full((R, n), -1, dtype=np.int64)
        cols, rows, ids = [], [], []
        for x in list(self.uf.parent):
            root = find(x)
            k = index.get(root)
            if k is None:
                k = index[root] = len(class_roots)
                class_roots.append(root)
                if type(root) is Wire and root.col < R and root.row < n:
                    cols.append(root.col)
                    rows.append(root.row)
                    ids.append(k)
            if type(x) is Wire and x.col < R and x.row < n:
                cols.append(x.col)
                rows.append(x.row)
                ids.append(k)
        wire_class[cols, rows] = ids
        return wire_class, class_roots

    # -- build ------------------------------------------------------------------
    def build(self, min_log_n: int | None = None,
              device=None) -> CircuitData:
        """Build circuit data. `min_log_n` pads the row count to at least
        2^min_log_n (pad_circuit_degree twin) so sibling circuits share one
        proof shape. The preprocessing and the proofs run on `device`: CUDA
        unless ``device="cpu"`` is given."""
        assert not self._built
        self._built = True
        cfg = self.config

        # public-input gate. <=4 PIs route directly into wires 0..3; more
        # are Poseidon-hashed in-circuit and the digest routed there (the
        # verifier recomputes the same hash from the claimed PIs — plonky2's
        # get_public_inputs_hash pattern).
        pi_gate = PublicInputGate()
        if len(self.public_inputs) > 4:
            digest = self.hash_n_to_hash_no_pad(list(self.public_inputs))
            pi_row = self.add_gate(pi_gate, ())
            for i in range(4):
                self.connect(digest[i], Wire(pi_row, i))
        else:
            pi_row = self.add_gate(pi_gate, ())
            for i, t in enumerate(self.public_inputs):
                self.connect(t, Wire(pi_row, i))
            for i in range(len(self.public_inputs), 4):
                # unused PI slots pinned to zero
                self.connect(Wire(pi_row, i), self.zero())

        # pad to power-of-two rows (noop rows)
        n_rows = len(self.rows) + cfg.num_blinding_rows
        log_n = max(3, (n_rows - 1).bit_length())
        if min_log_n is not None:
            assert log_n <= min_log_n, (
                f"circuit has {n_rows} rows (2^{log_n}) — exceeds the shared "
                f"shape's 2^{min_log_n}")
            log_n = min_log_n
        n = 1 << log_n
        rows: list[GateInstance | None] = list(self.rows) + \
            [None] * (n - len(self.rows))

        # unique gates + selector groups: declared gates first (canonical,
        # shape-shared), then any others by first appearance
        gates: list[Gate] = []
        gate_index: dict[str, int] = {}
        for g in self.declared_gates:
            gate_index[g.key] = len(gates)
            gates.append(g)
        for inst in rows:
            if inst and inst.gate.key not in gate_index:
                assert not self.declared_gates, (
                    f"gate {inst.gate.key} used but missing from the "
                    "declared (shape-shared) gate set")
                gate_index[inst.gate.key] = len(gates)
                gates.append(inst.gate)
        selector_groups = compute_selector_groups(gates, cfg)

        common = CommonData(config=cfg, log_n=log_n, gates=gates,
                            selector_groups=selector_groups,
                            num_public_inputs=len(self.public_inputs))

        # selector columns
        num_sel = len(selector_groups)
        sel = np.full((num_sel, n), UNUSED_SELECTOR, dtype=np.uint64)
        row_gate_id: list[Optional[int]] = []
        for r, inst in enumerate(rows):
            if inst is None:
                row_gate_id.append(None)
                continue
            gid = gate_index[inst.gate.key]
            row_gate_id.append(gid)
            sel[common.gate_group(gid), r] = gid

        # constant columns
        consts = np.zeros((cfg.num_constants, n), dtype=np.uint64)
        for r, inst in enumerate(rows):
            if inst is not None:
                for c, v in enumerate(inst.constants[:cfg.num_constants]):
                    consts[c, r] = v

        # sigma columns from copy-constraint cycles over routed wires
        R = cfg.num_routed_wires
        g_n = gl64.h_primitive_root_of_unity(log_n)
        subgroup = gl64.np_powers(g_n, n)                       # g^row
        k_is = common.k_is
        pos_val = np.empty((R, n), dtype=np.uint64)
        for i in range(R):
            pos_val[i] = gl64.np_mul(subgroup, np.uint64(k_is[i]))
        sigmas = pos_val.copy()            # identity permutation by default
        # copy classes over the routed wires: a wire the union-find never
        # joined is a class of its own (class -1, identity sigma); every
        # other wire takes its class's index into `class_roots`. A class's
        # cycle runs through its wires in row-major order, as the
        # reference's row-by-row scan collects them (virtual targets join
        # classes but hold no trace position).
        wire_class, class_roots = self._copy_classes(R, n)
        joined = np.flatnonzero(wire_class.T.reshape(-1) >= 0)  # row-major
        cls = wire_class.T.reshape(-1)[joined]
        order = np.argsort(cls, kind="stable")
        pos, cls = joined[order], cls[order]
        first = np.r_[0, np.flatnonzero(np.diff(cls)) + 1]
        size = np.diff(np.r_[first, len(cls)])
        nxt = np.arange(len(pos)) + 1
        nxt[first + size - 1] = first            # each cycle closes
        keep = np.repeat(size >= 2, size)
        src, dst = pos[keep], pos[nxt[keep]]
        sigmas[src % R, src // R] = pos_val[dst % R, dst // R]

        # preprocessing polynomials: [selectors, constants, sigmas].
        # NTTs/LDE/Merkle commitment are deferred (ProverData._preprocess)
        # so building circuits for witness checks / shape probing is cheap.
        values = np.concatenate([sel, consts, sigmas], axis=0)      # (S, n)
        prover = ProverData(rows=rows, row_gate_id=row_gate_id,
                            sigmas=sigmas, const_sigma_values=values,
                            subgroup=subgroup,
                            pi_targets=list(self.public_inputs),
                            log_n=log_n, rate_bits=cfg.rate_bits,
                            cap_height=cfg.fri.cap_height,
                            wire_classes=(wire_class, class_roots),
                            device=device)
        data = CircuitData(common=common, prover=prover)
        data._builder = self       # witness generation needs uf + rows
        return data

    # -- witness ------------------------------------------------------------------
def interp_and_lde(values: torch.Tensor, log_n: int, rate_bits: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., n) trace values -> (coeffs (..., n), coset-LDE values
    (..., M)) on the values' device: interpolate, then extend (on a CUDA
    tensor, the four-step kernels K1/K2 for both)."""
    coeffs = ntt.intt(values, log_n)
    return coeffs, ntt.coset_lde(coeffs, log_n, rate_bits)


