"""Orchestrator: block production — apply requested ops to the CityStore,
emit per-op delta-Merkle witnesses, plan the aggregation-tree job DAG,
and write the jobs' witnesses to the proof store.

Reference role: city_rollup_core_orchestrator (SURVEY.md §3.2/§3.3) —
CityOrchestratorBlockPlanner::process_requests (op application + witness
emission, op_processor.rs) + plan_jobs (DAG wiring, job_planner.rs).

Transition semantics match the new op circuits (op_circuits.py): per-tree
spans, combined H(user,other) commitments for two-tree ops, and the block
circuits' chaining of family spans into (old city root -> new city root).
Odd aggregation levels are padded with dummy (identity-transition) leaf
jobs instead of the reference's carried-up nodes — same proofs-per-level
shape, simpler ID arithmetic.

Counterpart of the port's ``rollup/orchestrator.py``: a copy of its
request types and of ``plan_block`` without an L1 context (the benchmark
plans no sighash chain), which is all the check replans.
"""

from __future__ import annotations

import dataclasses

from ..core import poseidon_host
from .circuits import encode_witness
from .city_store import CityStore
from .job_id import CircuitType, JobID, JobTopic
from .proof_store import QProofStore
from .treeprover import AggStateTransition, ZERO, generate_tree_inputs

Digest = tuple[int, int, int, int]


def _h2(a, b) -> Digest:
    return tuple(poseidon_host.two_to_one(list(a), list(b)))


# -- request types (the RPC ingress payloads, SURVEY.md §2.1 row 15) -----------

@dataclasses.dataclass
class RegisterUser:
    user_id: int
    public_key: Digest


@dataclasses.dataclass
class ClaimDeposit:
    user_id: int
    deposit_id: int
    txid224: Digest
    public_key: tuple               # 9-felt compressed L1 pubkey packing
    value: int
    l1_signature_proof: str | None = None    # encoded proof hex


@dataclasses.dataclass
class TokenTransfer:
    from_user: int
    to_user: int
    value: int
    signature_proof: str | None = None       # zk-wrapper proof hex


@dataclasses.dataclass
class AddWithdrawal:
    user_id: int
    withdrawal_id: int
    address: tuple                  # 3-limb hash160 packing
    value: int
    signature_proof: str | None = None


@dataclasses.dataclass
class ProcessWithdrawal:
    withdrawal_id: int


@dataclasses.dataclass
class AddDeposit:
    deposit_id: int
    txid224: Digest
    public_key: Digest
    value: int


@dataclasses.dataclass
class BlockRequests:
    register_users: list = dataclasses.field(default_factory=list)
    claim_deposits: list = dataclasses.field(default_factory=list)
    token_transfers: list = dataclasses.field(default_factory=list)
    add_withdrawals: list = dataclasses.field(default_factory=list)
    process_withdrawals: list = dataclasses.field(default_factory=list)
    add_deposits: list = dataclasses.field(default_factory=list)


FAMILY_ORDER = ["register", "claim", "transfer", "add_withdrawal",
                "process_withdrawal", "add_deposit"]
OP_CT = {
    "register": CircuitType.OP_REGISTER_USER,
    "claim": CircuitType.OP_CLAIM_L1_DEPOSIT,
    "transfer": CircuitType.OP_L2_TRANSFER,
    "add_withdrawal": CircuitType.OP_ADD_L1_WITHDRAWAL,
    "process_withdrawal": CircuitType.OP_PROCESS_L1_WITHDRAWAL,
    "add_deposit": CircuitType.OP_ADD_L1_DEPOSIT,
}
AGG_CT = {
    "register": CircuitType.AGG_REGISTER_USER,
    "claim": CircuitType.AGG_CLAIM_L1_DEPOSIT,
    "transfer": CircuitType.AGG_L2_TRANSFER,
    "add_withdrawal": CircuitType.AGG_ADD_L1_WITHDRAWAL,
    "process_withdrawal": CircuitType.AGG_PROCESS_L1_WITHDRAWAL,
    "add_deposit": CircuitType.AGG_ADD_L1_DEPOSIT,
}
DUMMY_CT = {
    "register": CircuitType.DUMMY_REGISTER_USER,
    "claim": CircuitType.DUMMY_CLAIM_L1_DEPOSIT,
    "transfer": CircuitType.DUMMY_L2_TRANSFER,
    "add_withdrawal": CircuitType.DUMMY_ADD_L1_WITHDRAWAL,
    "process_withdrawal": CircuitType.DUMMY_PROCESS_L1_WITHDRAWAL,
    "add_deposit": CircuitType.DUMMY_ADD_L1_DEPOSIT,
}


def _t_dict(t: AggStateTransition) -> dict:
    return {"start": list(t.start), "end": list(t.end),
            "events": list(t.events)}


@dataclasses.dataclass
class PlannedBlock:
    checkpoint_id: int
    start_city_root: Digest
    end_city_root: Digest
    leaf_jobs: list
    final_job: JobID
    notify_job: JobID
    num_jobs: int
    # events collected during op application (leaf values, in request order)
    withdrawal_events: list = dataclasses.field(default_factory=list)
    deposit_events: list = dataclasses.field(default_factory=list)


class Orchestrator:
    def __init__(self, city: CityStore, store: QProofStore, params=None):
        from .circuits import DEFAULT_PARAMS
        self.city = city
        self.store = store
        self.params = params or DEFAULT_PARAMS

    # -- op processor (op_processor.rs twin) -----------------------------------
    def _apply_op(self, cp: int, family: str, req):
        """Mutate the CityStore; return (circuit witness fields, leaf
        AggStateTransition matching the op circuit's PI semantics)."""
        c = self.city
        if family == "register":
            d = c.register_user(cp, req.user_id, req.public_key)
            return ({"user_id": req.user_id, "user_delta": d},
                    AggStateTransition(d.old_root, d.new_root, ZERO))
        if family == "claim":
            dep = c.mark_deposit_as_claimed(cp, req.deposit_id)
            usr = c.increment_user_balance(
                cp, req.user_id, req.value - self.params.deposit_fee)
            fields = {"user_id": req.user_id, "txid224": req.txid224,
                      "public_key": req.public_key, "value": req.value,
                      "deposit_delta": dep, "user_delta": usr}
            if getattr(req, "l1_signature_proof", None) is not None:
                fields["l1_signature_proof"] = req.l1_signature_proof
            return (fields,
                    AggStateTransition(_h2(usr.old_root, dep.old_root),
                                       _h2(usr.new_root, dep.new_root),
                                       ZERO))
        if family == "transfer":
            _, nonce, _ = c.get_user_state(req.from_user, cp)
            snd = c.decrement_user_balance(cp, req.from_user, req.value,
                                           new_nonce=nonce + 1)
            rcv = c.increment_user_balance(cp, req.to_user, req.value)
            fields = {"sender_id": req.from_user,
                      "receiver_id": req.to_user, "value": req.value,
                      "sender_delta": snd, "receiver_delta": rcv}
            if getattr(req, "signature_proof", None) is not None:
                fields["signature_proof"] = req.signature_proof
            return (fields,
                    AggStateTransition(snd.old_root, rcv.new_root, ZERO))
        if family == "add_withdrawal":
            wd = c.add_withdrawal(cp, req.withdrawal_id, req.address,
                                  req.value)
            _, nonce, _ = c.get_user_state(req.user_id, cp)
            usr = c.decrement_user_balance(
                cp, req.user_id, req.value + self.params.withdrawal_fee,
                new_nonce=nonce + 1)
            fields = {"user_id": req.user_id, "address": req.address,
                      "value": req.value, "user_delta": usr,
                      "withdrawal_delta": wd}
            if getattr(req, "signature_proof", None) is not None:
                fields["signature_proof"] = req.signature_proof
            return (fields,
                    AggStateTransition(_h2(usr.old_root, wd.old_root),
                                       _h2(usr.new_root, wd.new_root),
                                       ZERO))
        if family == "process_withdrawal":
            wd = c.mark_withdrawal_as_completed(cp, req.withdrawal_id)
            return ({"withdrawal_delta": wd},
                    AggStateTransition(wd.old_root, wd.new_root,
                                       wd.old_value))
        if family == "add_deposit":
            dep = c.add_deposit(cp, req.deposit_id, req.txid224,
                                req.public_key, req.value)
            return ({"txid224": req.txid224, "public_key": req.public_key,
                     "value": req.value, "deposit_delta": dep},
                    AggStateTransition(dep.old_root, dep.new_root,
                                       dep.new_value))
        raise ValueError(family)

    # -- block planner (planner.rs + job_planner.rs twin) -----------------------
    def plan_block(self, checkpoint_id: int, requests: BlockRequests
                   ) -> PlannedBlock:
        """Apply ops and build the aggregation DAG (job_planner.rs:14-56),
        without an L1 context."""
        cp = checkpoint_id
        city = self.city
        reqs_by_family = {
            "register": requests.register_users,
            "claim": requests.claim_deposits,
            "transfer": requests.token_transfers,
            "add_withdrawal": requests.add_withdrawals,
            "process_withdrawal": requests.process_withdrawals,
            "add_deposit": requests.add_deposits,
        }

        def roots():
            return (city.user_tree.get_root(cp),
                    city.withdrawal_tree.get_root(cp),
                    city.deposit_tree.get_root(cp))

        u_a, w_a, d_a = roots()
        start_city_root = city.get_city_root(cp)

        leaf_jobs_all: list[JobID] = []
        root_jobs: dict[str, JobID] = {}
        root_kinds: dict[str, str] = {}
        num_jobs = 0
        stage_roots = {}
        withdrawal_events: list = []
        deposit_events: list = []

        for group, family in enumerate(FAMILY_ORDER):
            reqs = reqs_by_family[family]
            leaves: list[AggStateTransition] = []
            leaf_jobs: list[JobID] = []
            kinds: list[str] = []
            for i, req in enumerate(reqs):
                fields, t = self._apply_op(cp, family, req)
                if family == "process_withdrawal":
                    withdrawal_events.append(tuple(t.events))
                elif family == "add_deposit":
                    deposit_events.append(tuple(t.events))
                leaves.append(t)
                kinds.append("leaf")
                job = JobID(JobTopic.GENERATE_STANDARD_PROOF, cp,
                            int(OP_CT[family]), group_id=group,
                            sub_group_id=0, task_index=i)
                self.store.set_bytes(job.input_witness_id(), encode_witness(
                    dict(fields, transition=_t_dict(t))))
                leaf_jobs.append(job)

            # family-end combined commitment: dummy identity point
            u_now, w_now, d_now = roots()
            dummy_x = {
                "register": u_now,
                "claim": _h2(u_now, d_now),
                "transfer": u_now,
                "add_withdrawal": _h2(u_now, w_now),
                "process_withdrawal": w_now,
                "add_deposit": d_now,
            }[family]

            # pad leaf count to a power of two with identity dummies (or a
            # single dummy for an empty family)
            want = 1 if not leaves else 1 << (len(leaves) - 1).bit_length()
            while len(leaves) < want or not leaves:
                t = AggStateTransition(dummy_x, dummy_x, ZERO)
                job = JobID(JobTopic.GENERATE_STANDARD_PROOF, cp,
                            int(DUMMY_CT[family]), group_id=group,
                            sub_group_id=0, task_index=len(leaves))
                self.store.set_bytes(job.input_witness_id(), encode_witness(
                    {"family": family, "state_root": list(dummy_x),
                     "transition": _t_dict(t)}))
                leaves.append(t)
                kinds.append("dummy")
                leaf_jobs.append(job)

            # per-family binary aggregation tree (perfect after padding)
            levels_inputs = generate_tree_inputs(leaves)
            levels_jobs: list[list[JobID]] = [leaf_jobs]
            prev_jobs, prev_kinds = leaf_jobs, kinds
            for lvl, inputs in enumerate(levels_inputs, start=1):
                jobs = []
                nkinds = []
                for inp in inputs:
                    assert inp.right is not None, "padded tree is perfect"
                    job = JobID(JobTopic.GENERATE_STANDARD_PROOF, cp,
                                int(AGG_CT[family]), group_id=group,
                                sub_group_id=lvl, task_index=inp.index)
                    self.store.set_bytes(
                        job.input_witness_id(),
                        encode_witness({
                            "family": family,
                            "children": [
                                prev_jobs[inp.index * 2].hex(),
                                prev_jobs[inp.index * 2 + 1].hex()],
                            "child_kinds": [
                                prev_kinds[inp.index * 2],
                                prev_kinds[inp.index * 2 + 1]],
                            "child_spans": [_t_dict(inp.left),
                                            _t_dict(inp.right)],
                            "transition": _t_dict(inp.condense())}))
                    jobs.append(job)
                    nkinds.append("agg")
                levels_jobs.append(jobs)
                prev_jobs, prev_kinds = jobs, nkinds
            self.store.write_multidimensional_jobs(levels_jobs, [])
            root_jobs[family] = prev_jobs[0]
            root_kinds[family] = prev_kinds[0]
            leaf_jobs_all.extend(leaf_jobs)
            num_jobs += sum(len(l) for l in levels_jobs)

            # record stage-boundary tree roots
            if family == "register":
                stage_roots["u_b"] = u_now
            elif family == "claim":
                stage_roots["u_c"], stage_roots["d_b"] = u_now, d_now
            elif family == "transfer":
                stage_roots["u_d"] = u_now
            elif family == "add_withdrawal":
                stage_roots["u_e"], stage_roots["w_b"] = u_now, w_now
            elif family == "process_withdrawal":
                stage_roots["w_c"] = w_now
            elif family == "add_deposit":
                stage_roots["d_c"] = d_now

        sr = stage_roots
        u_roots = [u_a, sr["u_b"], sr["u_c"], sr["u_d"], sr["u_e"]]
        w_roots = [w_a, sr["w_b"], sr["w_c"]]
        d_roots = [d_a, sr["d_b"], sr["d_c"]]

        # block aggregation: part1 (user-side families), part2, final
        part1 = JobID(JobTopic.GENERATE_STANDARD_PROOF, cp,
                      int(CircuitType.BLOCK_AGG_STATE_PART_1), group_id=100)
        part2 = JobID(JobTopic.GENERATE_STANDARD_PROOF, cp,
                      int(CircuitType.BLOCK_AGG_STATE_PART_2), group_id=101)
        final = JobID(JobTopic.GENERATE_STANDARD_PROOF, cp,
                      int(CircuitType.BLOCK_STATE_TRANSITION), group_id=102)
        notify = JobID(JobTopic.NOTIFY_ORCHESTRATOR_COMPLETE, cp,
                       int(CircuitType.UNKNOWN), group_id=103)

        self.store.set_bytes(part1.input_witness_id(), encode_witness({
            "children": {f: root_jobs[f].hex()
                         for f in ("register", "claim", "transfer")},
            "kinds": {f: root_kinds[f]
                      for f in ("register", "claim", "transfer")},
            "u_roots": [list(r) for r in u_roots[:4]],
            "d_roots": [list(r) for r in d_roots[:2]]}))
        self.store.write_next_jobs(
            [root_jobs[f] for f in ("register", "claim", "transfer")],
            [part1], counter_id=part1.counter_id())

        p2_families = ("add_withdrawal", "process_withdrawal", "add_deposit")
        self.store.set_bytes(part2.input_witness_id(), encode_witness({
            "children": {f: root_jobs[f].hex() for f in p2_families},
            "kinds": {f: root_kinds[f] for f in p2_families},
            "u_roots": [list(r) for r in u_roots[3:]],
            "w_roots": [list(r) for r in w_roots],
            "d_roots": [list(r) for r in d_roots[1:]]}))
        self.store.write_next_jobs([root_jobs[f] for f in p2_families],
                                   [part2], counter_id=part2.counter_id())

        self.store.set_bytes(final.input_witness_id(), encode_witness({
            "children": [part1.hex(), part2.hex()],
            "u_roots": [list(r) for r in u_roots],
            "w_roots": [list(r) for r in w_roots],
            "d_roots": [list(r) for r in d_roots]}))
        self.store.write_next_jobs([part1, part2], [final],
                                   counter_id=final.counter_id())
        num_jobs += 3

        end_city_root = city.get_city_root(cp)
        assert _h2(_h2(u_roots[4], w_roots[2]), d_roots[2]) == end_city_root
        planned = PlannedBlock(checkpoint_id=cp,
                               start_city_root=start_city_root,
                               end_city_root=end_city_root,
                               leaf_jobs=leaf_jobs_all, final_job=final,
                               notify_job=notify, num_jobs=num_jobs,
                               withdrawal_events=withdrawal_events,
                               deposit_events=deposit_events)
        self.store.write_next_jobs([final], [notify],
                                   counter_id=notify.counter_id())
        return planned
