"""Proof store + dependency-counter DAG — the entire distributed scheduler.

Semantics (reference: city_rollup_common/src/qworker/proof_store.rs:8-94 and
city_redis_store, SURVEY.md §2.9): proofs/witnesses are keyed by 24-byte job
IDs; writes are idempotent (set-if-not-exists); each job group has an atomic
counter cell storing (count, goal, next_jobs) — the worker whose increment
reaches the goal enqueues the dependents. ``write_multidimensional_jobs``
chains aggregation-tree levels so completing level i's last proof releases
level i+1. Leaderless, idempotent, at-least-once.

Backends: in-memory (single-process + threading.Lock — the testing fake and
the single-host fast path) and any Redis-compatible KV via the same interface.

Counterpart of the reference's ``rollup/proof_store.py``: a copy.
"""

from __future__ import annotations

import threading
from typing import Optional

from .job_id import JobID


class QProofStore:
    """Reader/writer interface (QProofStore{Reader,Writer}Sync twin)."""

    # -- data plane ----------------------------------------------------------
    def get_bytes(self, jid: JobID) -> Optional[bytes]:
        raise NotImplementedError

    def set_bytes(self, jid: JobID, data: bytes) -> None:
        """Idempotent (first write wins — hset_nx semantics)."""
        raise NotImplementedError

    def get_proof(self, jid: JobID) -> Optional[bytes]:
        return self.get_bytes(jid)

    def set_proof(self, jid: JobID, data: bytes) -> None:
        self.set_bytes(jid, data)

    # -- counter DAG ---------------------------------------------------------
    def inc_counter(self, counter_id: JobID,
                    job_id: JobID | None = None) -> int:
        """Atomically bump and return the new count. With `job_id`, the
        increment is EXACTLY-ONCE per (counter, job): a duplicate (network
        retry, at-least-once job redelivery) returns -1 and does not count —
        otherwise a replayed increment could release a parent early or
        overshoot the goal and deadlock the DAG."""
        raise NotImplementedError

    def get_goal(self, counter_id: JobID) -> int:
        raise NotImplementedError

    def get_next_jobs(self, counter_id: JobID) -> list[JobID]:
        raise NotImplementedError

    def write_next_jobs(self, jobs: list[JobID], next_jobs: list[JobID],
                        counter_id: JobID | None = None) -> None:
        """Install counter (count=0, goal=len(jobs), next_jobs) under the
        group counter cell of jobs[0] (proof_store.rs:46-58), or an explicit
        `counter_id` for cross-group joins (e.g. the three per-op-type tree
        roots releasing block-agg part 1), and register each job's
        membership."""
        counter = counter_id if counter_id is not None \
            else jobs[0].counter_id()
        self._install_counter(counter, goal=len(jobs),
                              next_jobs=list(next_jobs))
        for j in jobs:
            self._add_membership(j, counter)

    def write_multidimensional_jobs(self, levels: list[list[JobID]],
                                    final_next_jobs: list[JobID]) -> None:
        """Chain tree levels: completing all of level i enqueues level i+1;
        the last level releases final_next_jobs (proof_store.rs:65-87)."""
        for i, level in enumerate(levels):
            nxt = levels[i + 1] if i + 1 < len(levels) else final_next_jobs
            self.write_next_jobs(level, nxt)

    def _install_counter(self, counter_id: JobID, goal: int,
                         next_jobs: list[JobID]) -> None:
        raise NotImplementedError

    def _add_membership(self, jid: JobID, counter_id: JobID) -> None:
        raise NotImplementedError

    def memberships(self, jid: JobID) -> list[JobID]:
        raise NotImplementedError

    def on_job_complete(self, jid: JobID) -> list[JobID]:
        """Worker-side completion hook: bump every counter this job is a
        member of; return the dependents of any counter that hit its goal.
        Passing the job id makes each (counter, job) increment exactly-once
        under redelivery/retries."""
        released: list[JobID] = []
        for counter in self.memberships(jid):
            n = self.inc_counter(counter, jid)
            if n == self.get_goal(counter):
                released.extend(self.get_next_jobs(counter))
        return released


class MemoryProofStore(QProofStore):
    """Thread-safe in-memory store (SimpleProofStoreMemory twin,
    memory_proof_store/mod.rs:10-28)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._data: dict[bytes, bytes] = {}
        self._counters: dict[bytes, dict] = {}
        self._membership: dict[bytes, list[JobID]] = {}
        self._counted: set[tuple[bytes, bytes]] = set()

    def get_bytes(self, jid: JobID) -> Optional[bytes]:
        with self._lock:
            return self._data.get(jid.to_bytes())

    def set_bytes(self, jid: JobID, data: bytes) -> None:
        with self._lock:
            self._data.setdefault(jid.to_bytes(), data)

    def inc_counter(self, counter_id: JobID,
                    job_id: JobID | None = None) -> int:
        with self._lock:
            if job_id is not None:
                pair = (counter_id.to_bytes(), job_id.to_bytes())
                if pair in self._counted:
                    return -1            # duplicate: already counted
                self._counted.add(pair)
            c = self._counters[counter_id.to_bytes()]
            c["count"] += 1
            return c["count"]

    def get_goal(self, counter_id: JobID) -> int:
        with self._lock:
            return self._counters[counter_id.to_bytes()]["goal"]

    def get_next_jobs(self, counter_id: JobID) -> list[JobID]:
        with self._lock:
            return list(self._counters[counter_id.to_bytes()]["next"])

    def _install_counter(self, counter_id: JobID, goal: int,
                         next_jobs: list[JobID]) -> None:
        with self._lock:
            self._counters.setdefault(
                counter_id.to_bytes(),
                {"count": 0, "goal": goal, "next": next_jobs})

    def _add_membership(self, jid: JobID, counter_id: JobID) -> None:
        with self._lock:
            lst = self._membership.setdefault(jid.to_bytes(), [])
            if counter_id not in lst:
                lst.append(counter_id)

    def memberships(self, jid: JobID) -> list[JobID]:
        with self._lock:
            return list(self._membership.get(jid.to_bytes(), []))

    # -- dump/restore (checkpoint of an in-flight block; reference
    #    BlockProofStoreDump, SURVEY.md §5 "Checkpoint/resume") --------------
