"""Worker circuit toolbox: build every op/aggregation/dummy/block circuit
once at startup and dispatch proving jobs by circuit type.

Reference role: city_rollup_circuit/src/worker/toolbox (SURVEY.md §2.10) —
`CRWorkerToolboxCoreCircuits` builds all circuits up front (deriving every
fingerprint) and `worker_prove` dispatches on `job_id.circuit_type`.

Round-2 semantics: every proof is real — op circuits verify delta-Merkle
state updates in-circuit, aggregation nodes recursively verify their
children's FRI proofs against the family's shared proof shape, and the
block circuits chain the per-family spans into one
(old city root -> new city root) claim. See op_circuits.py.

Counterpart of the reference's ``rollup/circuits.py``, on the port's
prover: every circuit is built for one device (``CircuitToolbox(...,
device=)``), where its preprocessing and its proofs run, the
signature wrapper's (``with_signatures=True``) too. Still missing: the
Groth16 wrap (ROADMAP A12c) and the network services (A12d).
"""

from __future__ import annotations

import json

from ..core import fri
from ..snark import CircuitConfig
from ..snark.recursion import fingerprint_verifier_data
from . import op_circuits as oc
from .job_id import CircuitType
from .merkle_model import DeltaMerkleProof

# proving config for rollup circuits (tests shrink FRI + tree heights)
DEFAULT_CONFIG = CircuitConfig.poseidon_config()
FAST_TEST_CONFIG = CircuitConfig.poseidon_config(
    num_challenges=1,
    fri=fri.FriConfig(rate_bits=3, cap_height=1, proof_of_work_bits=4,
                      num_query_rounds=4, final_poly_bits=3))

DEFAULT_PARAMS = oc.RollupParams(config=DEFAULT_CONFIG)
FAST_TEST_PARAMS = oc.RollupParams(
    config=FAST_TEST_CONFIG, user_tree_height=8, deposit_tree_height=8,
    withdrawal_tree_height=8)

SHAPE_A_OPS = {
    "register": oc.make_register_user,
    "claim": oc.make_claim_l1_deposit,
    "transfer": oc.make_l2_transfer,
    "add_withdrawal": oc.make_add_l1_withdrawal,
}
SHAPE_B_OPS = {
    "process_withdrawal": oc.make_process_l1_withdrawal,
    "add_deposit": oc.make_add_l1_deposit,
}

OP_NAME_BY_TYPE = {
    CircuitType.OP_REGISTER_USER: "register",
    CircuitType.OP_CLAIM_L1_DEPOSIT: "claim",
    CircuitType.OP_L2_TRANSFER: "transfer",
    CircuitType.OP_ADD_L1_WITHDRAWAL: "add_withdrawal",
    CircuitType.OP_PROCESS_L1_WITHDRAWAL: "process_withdrawal",
    CircuitType.OP_ADD_L1_DEPOSIT: "add_deposit",
}
FAMILY_BY_AGG = {
    CircuitType.AGG_REGISTER_USER: "register",
    CircuitType.AGG_CLAIM_L1_DEPOSIT: "claim",
    CircuitType.AGG_L2_TRANSFER: "transfer",
    CircuitType.AGG_ADD_L1_WITHDRAWAL: "add_withdrawal",
    CircuitType.AGG_PROCESS_L1_WITHDRAWAL: "process_withdrawal",
    CircuitType.AGG_ADD_L1_DEPOSIT: "add_deposit",
}
FAMILY_BY_DUMMY = {
    CircuitType.DUMMY_REGISTER_USER: "register",
    CircuitType.DUMMY_CLAIM_L1_DEPOSIT: "claim",
    CircuitType.DUMMY_L2_TRANSFER: "transfer",
    CircuitType.DUMMY_ADD_L1_WITHDRAWAL: "add_withdrawal",
    CircuitType.DUMMY_PROCESS_L1_WITHDRAWAL: "process_withdrawal",
    CircuitType.DUMMY_ADD_L1_DEPOSIT: "add_deposit",
}
SHAPE_BY_FAMILY = {"register": "A", "claim": "A", "transfer": "A",
                   "add_withdrawal": "A", "process_withdrawal": "B",
                   "add_deposit": "B"}


class CircuitToolbox:
    """Builds both shape families + block circuits; proves/verifies by
    circuit type. Build order mirrors the reference's explicit dependency
    chain (circuits.rs:87-95): leaf ops -> family aggregators -> block
    aggregators -> block state transition."""

    def __init__(self, params: oc.RollupParams | None = None,
                 with_signatures: bool = False, device=None):
        """`device`: where every circuit's preprocessing and proofs run
        (CUDA unless ``device="cpu"``). `with_signatures=True` builds the
        ZK-signature wrapper circuit first, on `device`, and threads it
        into the op circuits, which then recursively verify user
        signature proofs in-circuit (the reference's build order:
        zk_signature_wrapper -> ops, circuits.rs:87-95)."""
        self.params = params or DEFAULT_PARAMS
        self.device = device
        self.zk_wrapper = None
        if with_signatures:
            raise NotImplementedError(
                "the reference copy builds no signature wrapper")
        self._family_a = None
        self._family_b = None
        self._block = None

    # -- lazy family/block builds ------------------------------------------------
    @property
    def family_a(self) -> oc.ShapeFamily:
        if self._family_a is None:
            self._family_a = oc.build_shape_family(self.params, SHAPE_A_OPS,
                                                   with_events=False,
                                                   device=self.device)
        return self._family_a

    @property
    def family_b(self) -> oc.ShapeFamily:
        if self._family_b is None:
            self._family_b = oc.build_shape_family(self.params, SHAPE_B_OPS,
                                                   with_events=True,
                                                   device=self.device)
        return self._family_b

    def _family_for(self, name: str) -> oc.ShapeFamily:
        return self.family_a if SHAPE_BY_FAMILY[name] == "A" else \
            self.family_b

    def family_fps(self, name: str) -> oc.FamilyFps:
        fam = self._family_for(name)
        return oc.FamilyFps(
            leaf=tuple(fingerprint_verifier_data(
                fam.leaves[name].data.verifier)),
            agg=tuple(fingerprint_verifier_data(fam.agg.data.verifier)),
            dummy=tuple(fingerprint_verifier_data(fam.dummy.data.verifier)))

    def allowed_root(self, name: str) -> tuple:
        return self.family_fps(name).allowed_root

    # -- proving -----------------------------------------------------------------
    # Each op/dummy/agg job has a `prepare_*` form returning (CircuitData,
    # PartialWitness) so the worker can group same-circuit jobs and prove
    # them as ONE batched device call (snark_prover.prove_batch — SURVEY.md
    # §2.11 "levels batched").

    # -- verification -------------------------------------------------------------
# -- proof/witness (de)serialization for the proof store ----------------------

def delta_to_dict(d: DeltaMerkleProof) -> dict:
    return {"old_root": list(d.old_root), "old_value": list(d.old_value),
            "new_root": list(d.new_root), "new_value": list(d.new_value),
            "index": d.index, "siblings": [list(s) for s in d.siblings]}


def delta_from_dict(raw: dict) -> DeltaMerkleProof:
    return DeltaMerkleProof(
        old_root=tuple(raw["old_root"]), old_value=tuple(raw["old_value"]),
        new_root=tuple(raw["new_root"]), new_value=tuple(raw["new_value"]),
        index=raw["index"], siblings=[tuple(s) for s in raw["siblings"]])


def encode_witness(payload: dict) -> bytes:
    def enc(v):
        if isinstance(v, DeltaMerkleProof):
            return {"__delta__": delta_to_dict(v)}
        if isinstance(v, tuple):
            return list(v)
        return v
    return json.dumps({k: enc(v) for k, v in payload.items()}).encode()


def decode_witness(raw: bytes) -> dict:
    def dec(v):
        if isinstance(v, dict) and "__delta__" in v:
            return delta_from_dict(v["__delta__"])
        return v
    return {k: dec(v) for k, v in json.loads(raw.decode()).items()}


