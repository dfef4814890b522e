"""Worker actor: pop job -> prove -> store proof -> bump counters -> release
dependents. Leaderless and idempotent; any number of workers can run against
the same proof store + queues.

Reference role: city_rollup_core_worker SimpleActorWorker::process_next_job
(SURVEY.md §3.1 hot path; §2.1 row 12), including per-job wall-clock
benchmarks (QWorkerJobBenchmark twin) and worker-mode filtering.

Counterpart of the reference's ``rollup/worker.py``: a copy.
"""

from __future__ import annotations

import dataclasses
import time

from .circuits import (CircuitToolbox, decode_proof, decode_witness,
                       encode_proof)
from .job_id import JobID, JobTopic, WorkerMode
from .proof_store import QProofStore
from .queues import Q_JOB, Q_NOTIFICATIONS, QueueHub
from .treeprover import AggStateTransition


@dataclasses.dataclass
class JobBenchmark:
    job_id: str
    duration_ms: float


def _transition_from(d: dict) -> AggStateTransition:
    return AggStateTransition(start=tuple(d["start"]), end=tuple(d["end"]),
                              events=tuple(d.get("events", (0, 0, 0, 0))))


class Worker:
    def __init__(self, toolbox: CircuitToolbox, store: QProofStore,
                 hub: QueueHub, mode: WorkerMode = WorkerMode.ALL,
                 sighash_toolbox=None):
        """`sighash_toolbox`: optional rollup.sighash_toolbox.SigHashToolbox
        enabling the SIGHASH_* / WRAP_* circuit types (reference: the worker
        root toolbox carries the sighash circuits, root.rs:53-139)."""
        self.toolbox = toolbox
        self.store = store
        self.hub = hub
        self.mode = mode
        self.sighash = sighash_toolbox
        self.benchmarks: list[JobBenchmark] = []
        #: sizes of same-circuit groups proven via prove_batch (fleet
        #: observability: the batched-drain path is the TPU win — SURVEY.md
        #: §2.11 "levels batched")
        self.batched_groups: list[int] = []

    # -- event loop ------------------------------------------------------------
    def process_next_job(self) -> bool:
        """Returns True if a job was processed."""
        got = self.hub.receive(Q_JOB)
        if got is None:
            return False
        mid, msg = got
        job = JobID.from_bytes(msg)
        if not self._accepts_job(job):
            # not ours: put it back for a specialized worker
            self.hub.ack(Q_JOB, mid)
            self.hub.dispatch(Q_JOB, msg)
            return False
        t0 = time.perf_counter()
        self.process_job(job)
        self.benchmarks.append(JobBenchmark(
            job_id=job.hex(),
            duration_ms=(time.perf_counter() - t0) * 1e3))
        self.hub.ack(Q_JOB, mid)
        return True

    def _accepts_job(self, job: JobID) -> bool:
        """Mode + capability filter: jobs this worker must leave for a
        specialized/sighash-equipped worker."""
        from .job_id import CircuitType
        if not self.mode.accepts(job):
            return False
        if self.sighash is None and job.circuit_type in (
                CircuitType.SIGHASH_INTROSPECTION,
                CircuitType.SIGHASH_WRAPPER, CircuitType.SIGHASH_FINAL_GL,
                CircuitType.WRAP_FINAL_SIGHASH_PROOF_BLS12381):
            return False
        return True

    def process_ready_batch(self, max_batch: int = 8) -> int:
        """Batched drain (SURVEY.md §2.11 "levels batched"): pop up to
        `max_batch` ready jobs, group the op/dummy/agg jobs that share ONE
        circuit, prove each group with a single batched device call
        (snark_prover.prove_batch), and fall back to per-job proving for
        everything else. Returns the number of jobs processed."""
        import time as _time

        popped: list[tuple[int, JobID]] = []
        while len(popped) < max_batch:
            got = self.hub.receive(Q_JOB)
            if got is None:
                break
            mid, msg = got
            job = JobID.from_bytes(msg)
            if not self._accepts_job(job):
                # not ours: put it back for another worker and STOP popping
                # this round (re-dispatching makes it immediately visible —
                # continuing would re-receive it in a busy loop)
                self.hub.ack(Q_JOB, mid)
                self.hub.dispatch(Q_JOB, msg)
                break
            popped.append((mid, job))
        if not popped:
            return 0

        # group batchable jobs by their circuit object
        groups: dict[int, list] = {}
        singles: list[tuple[int, JobID]] = []
        for mid, job in popped:
            prep = self._try_prepare(job)
            if prep is None:
                singles.append((mid, job))
            else:
                data, pw = prep
                groups.setdefault(id(data), []).append((mid, job, data, pw))

        from ..snark import prover as snark_prover
        done = 0
        for members in groups.values():
            self.batched_groups.append(len(members))
            t0 = _time.perf_counter()
            proofs = snark_prover.prove_batch(
                members[0][2], [pw for (_, _, _, pw) in members])
            per_ms = (_time.perf_counter() - t0) * 1e3 / len(members)
            for (mid, job, _, _), proof in zip(members, proofs):
                self.store.set_bytes(job.output_proof_id(),
                                     encode_proof(proof))
                self._release(job)
                self.benchmarks.append(JobBenchmark(job_id=job.hex(),
                                                    duration_ms=per_ms))
                self.hub.ack(Q_JOB, mid)
                done += 1
        for mid, job in singles:
            t0 = _time.perf_counter()
            self.process_job(job)
            self.benchmarks.append(JobBenchmark(
                job_id=job.hex(),
                duration_ms=(_time.perf_counter() - t0) * 1e3))
            self.hub.ack(Q_JOB, mid)
            done += 1
        return done

    def _try_prepare(self, job: JobID):
        """(data, pw) for batchable circuit types; None for the rest."""
        from .circuits import FAMILY_BY_AGG, FAMILY_BY_DUMMY, OP_NAME_BY_TYPE
        ct = job.circuit_type
        if ct not in OP_NAME_BY_TYPE and ct not in FAMILY_BY_DUMMY and \
                ct not in FAMILY_BY_AGG:
            return None
        raw = self.store.get_bytes(job.input_witness_id())
        assert raw is not None, f"missing witness for {job}"
        w = decode_witness(raw)
        if ct in OP_NAME_BY_TYPE:
            for key in ("signature_proof", "l1_signature_proof"):
                if key in w:
                    w[key] = decode_proof(bytes.fromhex(w[key]))
            return self.toolbox.prepare_op(OP_NAME_BY_TYPE[ct], w)
        if ct in FAMILY_BY_DUMMY:
            return self.toolbox.prepare_dummy(FAMILY_BY_DUMMY[ct],
                                              tuple(w["state_root"]))
        children = [
            (self._child_proof(ch), kind,
             (tuple(span["start"]), tuple(span["end"])))
            for ch, kind, span in zip(w["children"], w["child_kinds"],
                                      w["child_spans"])]
        return self.toolbox.prepare_agg(FAMILY_BY_AGG[ct], children)

    def _release(self, job: JobID):
        for nj in self.store.on_job_complete(job):
            if nj.topic == JobTopic.NOTIFY_ORCHESTRATOR_COMPLETE:
                self.hub.dispatch(Q_NOTIFICATIONS, nj.to_bytes())
            else:
                self.hub.dispatch(Q_JOB, nj.to_bytes())

    def process_job(self, job: JobID):
        from .job_id import CircuitType
        if job.circuit_type == CircuitType.WRAP_FINAL_SIGHASH_PROOF_BLS12381:
            # terminal wrap: output is CityGroth16ProofData JSON, not a
            # Goldilocks proof (root.rs:256-318)
            import json
            assert self.sighash is not None, "worker lacks sighash toolbox"
            raw = self.store.get_bytes(job.input_witness_id())
            w = decode_witness(raw)
            final = self._child_proof(w["final"])
            res = self.sighash.wrap_groth16(final)
            payload = {"proof_data": res["proof_data"],
                       "public_inputs": [str(x)
                                         for x in res["public_inputs"]]}
            self.store.set_bytes(job.output_proof_id(),
                                 json.dumps(payload).encode())
        else:
            proof = self.prove_job(job)
            self.store.set_bytes(job.output_proof_id(), encode_proof(proof))
        self._release(job)

    # -- proving ------------------------------------------------------------------
    def _child_proof(self, job_hex: str):
        child = JobID.from_bytes(bytes.fromhex(job_hex))
        craw = self.store.get_proof(child.output_proof_id())
        assert craw is not None, f"missing child proof {child}"
        return decode_proof(craw)

    def prove_job(self, job: JobID):
        """Dispatch on circuit type against the toolbox (worker_prove twin,
        toolbox/root.rs:229-254). Aggregation and block nodes verify their
        children IN-CIRCUIT (recursive FRI verification); the worker only
        fetches witnesses + child proofs from the store."""
        from .circuits import FAMILY_BY_AGG, FAMILY_BY_DUMMY, OP_NAME_BY_TYPE
        from .job_id import CircuitType
        raw = self.store.get_bytes(job.input_witness_id())
        assert raw is not None, f"missing witness for {job}"
        w = decode_witness(raw)
        ct = job.circuit_type
        tb = self.toolbox

        if ct in OP_NAME_BY_TYPE:
            # user signature proofs travel in the witness as encoded hex
            # (reference: the rpc_processor assigns signature-proof job IDs
            # and ops read them from the store, job_id.rs:288-327)
            for key in ("signature_proof", "l1_signature_proof"):
                if key in w:
                    w[key] = decode_proof(bytes.fromhex(w[key]))
            return tb.prove_op(OP_NAME_BY_TYPE[ct], w)
        if ct in FAMILY_BY_DUMMY:
            return tb.prove_dummy(FAMILY_BY_DUMMY[ct],
                                  tuple(w["state_root"]))
        if ct in FAMILY_BY_AGG:
            children = [
                (self._child_proof(ch), kind,
                 (tuple(span["start"]), tuple(span["end"])))
                for ch, kind, span in zip(w["children"], w["child_kinds"],
                                          w["child_spans"])]
            return tb.prove_agg(FAMILY_BY_AGG[ct], children)
        if ct == CircuitType.BLOCK_AGG_STATE_PART_1:
            proofs = {f: self._child_proof(h)
                      for f, h in w["children"].items()}
            return tb.prove_block_part1(
                proofs, w["kinds"],
                [tuple(r) for r in w["u_roots"]],
                [tuple(r) for r in w["d_roots"]])
        if ct == CircuitType.BLOCK_AGG_STATE_PART_2:
            proofs = {f: self._child_proof(h)
                      for f, h in w["children"].items()}
            return tb.prove_block_part2(
                proofs, w["kinds"],
                [tuple(r) for r in w["u_roots"]],
                [tuple(r) for r in w["w_roots"]],
                [tuple(r) for r in w["d_roots"]])
        if ct == CircuitType.BLOCK_STATE_TRANSITION:
            p1 = self._child_proof(w["children"][0])
            p2 = self._child_proof(w["children"][1])
            return tb.prove_block_transition(
                p1, p2,
                [tuple(r) for r in w["u_roots"]],
                [tuple(r) for r in w["w_roots"]],
                [tuple(r) for r in w["d_roots"]])

        # -- sighash chain (finalizer.rs/job_planner.rs circuit types 21-24) --
        if ct == CircuitType.SIGHASH_INTROSPECTION:
            assert self.sighash is not None, "worker lacks sighash toolbox"
            from .btc import BlockSpendIntrospectionHint
            hint = BlockSpendIntrospectionHint.from_dict(w["hint"])
            return self.sighash.prove_introspection(hint)
        if ct == CircuitType.SIGHASH_WRAPPER:
            assert self.sighash is not None, "worker lacks sighash toolbox"
            child = self._child_proof(w["child"])
            return self.sighash.prove_wrapper(child, int(w["gid"]))
        if ct == CircuitType.SIGHASH_FINAL_GL:
            assert self.sighash is not None, "worker lacks sighash toolbox"
            tr = self._child_proof(w["transition"])
            wr = self._child_proof(w["wrapper"])
            return self.sighash.prove_final(
                tr, wr, {"cur_bal": w["cur_bal"], "next_bal": w["next_bal"],
                         "spend_idx": w["spend_idx"]})
        raise ValueError(f"unknown circuit type {ct}")
