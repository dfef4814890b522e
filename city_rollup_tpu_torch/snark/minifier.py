"""Proof minifier: recursively re-wrap a proof in a new circuit whose
verifier data is a circuit constant, shrinking/normalizing the proof shape;
chain N wrappers for further shrinking.

Reference role: city_common_circuit/src/proof_minifier/{pm_core, pm_chain,
pm_chain_dynamic}.rs (SURVEY.md §2.2 "Proof minifier") — used by the
reference to (a) squeeze a zk-config signature proof down to the standard
recursion shape, (b) shrink sighash introspection proofs through a 3-stage
chain (sighash.rs:114-118), and (c) normalize any proof before the Groth16
wrap (SimpleWrapperDynamic role for the constant-verifier-data case).

TPU-first note: a wrapper circuit is dominated by the in-circuit FRI
verifier, whose constraint evaluation runs as the same batched device passes
as any other circuit; minification is therefore "free" parallel work on the
aggregation fleet rather than a special pipeline stage.

Counterpart of the reference's ``snark/minifier.py``: the same code over the port's
``core/`` and ``snark/`` (host Python; the proofs it builds circuits for
run on the port's prover).
"""

from __future__ import annotations

import dataclasses

from . import recursion
from .circuit import CircuitBuilder, CircuitData
from .config import CircuitConfig
from . import prover as snark_prover
from .prover import Proof


@dataclasses.dataclass
class ProofMinifier:
    """One wrap step (pm_core.rs OASProofMinifier twin): a circuit that
    verifies proofs of `inner_common` under the fixed `inner_verifier` data
    and re-exposes the inner public inputs unchanged. Its proofs run on
    `device` (CUDA unless ``device="cpu"``), as ``CircuitBuilder.build``'s
    do."""
    data: CircuitData
    proof_targets: object
    inner_common: object

    @classmethod
    def build(cls, inner: CircuitData, config: CircuitConfig | None = None,
              declared_gates: list | None = None,
              min_log_n: int | None = None,
              device=None) -> "ProofMinifier":
        b = CircuitBuilder(config or inner.common.config)
        if declared_gates:
            b.declare_gates(declared_gates)
        pt = recursion.add_virtual_proof(b, inner.common)
        vdt = recursion.constant_verifier_data(b, inner.verifier)
        recursion.verify_proof_gadget(b, pt, inner.common, vdt)
        b.register_public_inputs(list(pt.public_inputs))
        data = b.build(min_log_n=min_log_n, device=device)
        return cls(data=data, proof_targets=pt, inner_common=inner.common)

    def prove(self, inner_proof: Proof) -> Proof:
        pw = self.data._builder.partial_witness()
        recursion.set_proof_witness(pw, self.proof_targets, inner_proof)
        return snark_prover.prove(self.data, pw)

    @property
    def fingerprint(self) -> tuple:
        return tuple(recursion.fingerprint_verifier_data(self.data.verifier))


@dataclasses.dataclass
class MinifierChain:
    """N chained wrap steps (pm_chain.rs OASProofMinifierChain twin)."""
    steps: list

    @classmethod
    def build(cls, inner: CircuitData, n_steps: int,
              config: CircuitConfig | None = None,
              device=None) -> "MinifierChain":
        steps = []
        cur = inner
        for _ in range(n_steps):
            step = ProofMinifier.build(cur, config, device=device)
            steps.append(step)
            cur = step.data
        return cls(steps=steps)

    @property
    def data(self) -> CircuitData:
        return self.steps[-1].data if self.steps else None

    def prove(self, inner_proof: Proof) -> Proof:
        p = inner_proof
        for step in self.steps:
            p = step.prove(p)
        return p

    @property
    def fingerprint(self) -> tuple:
        return self.steps[-1].fingerprint
