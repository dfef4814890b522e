"""Addressable proving-job IDs: 24-byte tuples with pure-arithmetic tree
navigation.

Reference role: city_rollup_common/src/qworker/job_id.rs (SURVEY.md §2.8) —
(topic u8, goal_id u64, circuit_type u8, group_id u32, sub_group_id u32,
task_index u32, data_type u8, data_index u8); aggregation-tree parents are
computed by ID arithmetic alone (halve task_index, bump sub_group_id).

Counterpart of the reference's ``rollup/job_id.py``: a copy.
"""

from __future__ import annotations

import dataclasses
import enum
import struct


class JobTopic(enum.IntEnum):
    GENERATE_STANDARD_PROOF = 0
    GENERATE_GROTH16_PROOF = 1
    BLOCK_USER_SIGNATURE_PROOF = 2
    NOTIFY_ORCHESTRATOR_COMPLETE = 3
    AGGREGATE_JOBS = 4


class CircuitType(enum.IntEnum):
    # op leaves
    OP_REGISTER_USER = 0
    OP_CLAIM_L1_DEPOSIT = 1
    OP_L2_TRANSFER = 2
    OP_ADD_L1_WITHDRAWAL = 3
    OP_PROCESS_L1_WITHDRAWAL = 4
    OP_ADD_L1_DEPOSIT = 5
    # binary aggregators per op type
    AGG_REGISTER_USER = 6
    AGG_CLAIM_L1_DEPOSIT = 7
    AGG_L2_TRANSFER = 8
    AGG_ADD_L1_WITHDRAWAL = 9
    AGG_PROCESS_L1_WITHDRAWAL = 10
    AGG_ADD_L1_DEPOSIT = 11
    # dummies (identity transitions for empty op sets)
    DUMMY_REGISTER_USER = 12
    DUMMY_CLAIM_L1_DEPOSIT = 13
    DUMMY_L2_TRANSFER = 14
    DUMMY_ADD_L1_WITHDRAWAL = 15
    DUMMY_PROCESS_L1_WITHDRAWAL = 16
    DUMMY_ADD_L1_DEPOSIT = 17
    # block-level circuits
    BLOCK_AGG_STATE_PART_1 = 18
    BLOCK_AGG_STATE_PART_2 = 19
    BLOCK_STATE_TRANSITION = 20
    SIGHASH_INTROSPECTION = 21
    SIGHASH_WRAPPER = 22
    SIGHASH_FINAL_GL = 23
    WRAP_FINAL_SIGHASH_PROOF_BLS12381 = 24
    # signature leaves
    ZK_SIGNATURE = 25
    SECP256K1_SIGNATURE = 26
    UNKNOWN = 255


OP_TO_AGG = {
    CircuitType.OP_REGISTER_USER: CircuitType.AGG_REGISTER_USER,
    CircuitType.OP_CLAIM_L1_DEPOSIT: CircuitType.AGG_CLAIM_L1_DEPOSIT,
    CircuitType.OP_L2_TRANSFER: CircuitType.AGG_L2_TRANSFER,
    CircuitType.OP_ADD_L1_WITHDRAWAL: CircuitType.AGG_ADD_L1_WITHDRAWAL,
    CircuitType.OP_PROCESS_L1_WITHDRAWAL: CircuitType.AGG_PROCESS_L1_WITHDRAWAL,
    CircuitType.OP_ADD_L1_DEPOSIT: CircuitType.AGG_ADD_L1_DEPOSIT,
}
AGG_TYPES = set(OP_TO_AGG.values())


class JobDataType(enum.IntEnum):
    INPUT_WITNESS = 0
    BASE_INPUT_PROOF = 1
    OUTPUT_PROOF = 8
    COUNTER = 16


_STRUCT = struct.Struct(">BQBIIIBB")       # 24 bytes big-endian


@dataclasses.dataclass(frozen=True, order=True)
class JobID:
    topic: int
    goal_id: int                 # block number
    circuit_type: int
    group_id: int = 0
    sub_group_id: int = 0        # tree level for aggregation jobs
    task_index: int = 0          # node index within the level
    data_type: int = int(JobDataType.OUTPUT_PROOF)
    data_index: int = 0

    def to_bytes(self) -> bytes:
        return _STRUCT.pack(self.topic, self.goal_id, self.circuit_type,
                            self.group_id, self.sub_group_id, self.task_index,
                            self.data_type, self.data_index)

    @classmethod
    def from_bytes(cls, b: bytes) -> "JobID":
        return cls(*_STRUCT.unpack(b))

    def hex(self) -> str:
        return self.to_bytes().hex()

    # -- derived IDs ---------------------------------------------------------
    def with_data(self, data_type: int, data_index: int = 0) -> "JobID":
        return dataclasses.replace(self, data_type=data_type,
                                   data_index=data_index)

    def input_witness_id(self, index: int = 0) -> "JobID":
        return self.with_data(JobDataType.INPUT_WITNESS, index)

    def output_proof_id(self) -> "JobID":
        return self.with_data(JobDataType.OUTPUT_PROOF, 0)

    def counter_id(self) -> "JobID":
        """The dependency counter cell for this job's group+level."""
        return dataclasses.replace(self, task_index=0,
                                   data_type=int(JobDataType.COUNTER),
                                   data_index=0)

    def tree_parent(self) -> "JobID":
        """Aggregation-tree parent: leaf op types map to their agg type;
        agg nodes stay agg; task_index halves; sub_group_id (level) bumps.
        Mirrors job_id.rs get_tree_parent_proof_input_id (SURVEY.md §2.8)."""
        ct = CircuitType(self.circuit_type)
        parent_ct = OP_TO_AGG.get(ct, ct)
        assert parent_ct in AGG_TYPES, f"no tree parent for {ct!r}"
        return dataclasses.replace(
            self, circuit_type=int(parent_ct),
            sub_group_id=self.sub_group_id + 1,
            task_index=self.task_index // 2)

    def is_dummy(self) -> bool:
        return (CircuitType.DUMMY_REGISTER_USER <= self.circuit_type
                <= CircuitType.DUMMY_ADD_L1_DEPOSIT)


class WorkerMode(enum.Enum):
    """Worker specialization flags (reference QWorkerMode, job_id.rs:585-593)."""
    ALL = "all"
    NO_GROTH16 = "no_groth16"
    ONLY_GROTH16 = "only_groth16"

    def accepts(self, job: JobID) -> bool:
        is_g16 = job.topic == JobTopic.GENERATE_GROTH16_PROOF
        if self is WorkerMode.NO_GROTH16:
            return not is_g16
        if self is WorkerMode.ONLY_GROTH16:
            return is_g16
        return True
