"""qbench: replay a dumped block proof store through a worker N times,
recording per-job durations.

Reference role: city_rollup_core_worker_qbench (SURVEY.md §2.1 row 14) —
the dump format is MemoryProofStore.dump() (witnesses + counters + DAG),
the replay re-enqueues the block's leaf jobs and drains the DAG with a
fresh worker, emitting the same [{job_id, duration_ms}] JSON shape.

Counterpart of the reference's ``rollup/qbench.py``: a copy.
"""

from __future__ import annotations

import dataclasses
import json

from .circuits import CircuitToolbox
from .job_id import JobID
from .proof_store import MemoryProofStore
from .queues import Q_JOB, QueueHub
from .worker import Worker


@dataclasses.dataclass
class BlockProofStoreDump:
    """Replayable block: the planned proof store + the leaf jobs to enqueue."""
    store_dump: dict
    leaf_jobs: list[str]            # hex job ids

    def to_json(self) -> str:
        return json.dumps({"store": self.store_dump,
                           "leaf_jobs": self.leaf_jobs})

    @classmethod
    def from_json(cls, raw: str) -> "BlockProofStoreDump":
        d = json.loads(raw)
        return cls(store_dump=d["store"], leaf_jobs=d["leaf_jobs"])


def dump_block(store: MemoryProofStore, planned) -> BlockProofStoreDump:
    return BlockProofStoreDump(store_dump=store.dump(),
                               leaf_jobs=[j.hex() for j in planned.leaf_jobs])


def run_worker_qbench(dump: BlockProofStoreDump, toolbox: CircuitToolbox,
                      num_rounds: int = 1, batch: int = 1) -> list[dict]:
    """Replay the dumped block num_rounds times; returns
    [{job_id, duration_ms}] across all rounds (qbench.rs:15-66 twin).
    `batch > 1` drains through the batched-prove path (same-circuit ready
    jobs grouped into one device call) — the apples-to-apples comparison
    of the TPU-native scheduling win over per-job proving."""
    results: list[dict] = []
    for _ in range(num_rounds):
        store = MemoryProofStore.restore(dump.store_dump)
        hub = QueueHub()
        for j in dump.leaf_jobs:
            hub.dispatch(Q_JOB, bytes.fromhex(j))
        worker = Worker(toolbox, store, hub)
        if batch > 1:
            while worker.process_ready_batch(max_batch=batch):
                pass
        else:
            while worker.process_next_job():
                pass
        results.extend({"job_id": b.job_id, "duration_ms": b.duration_ms}
                       for b in worker.benchmarks)
    return results
