"""Orchestrator: block production — apply requested ops to the CityStore,
emit per-op delta-Merkle witnesses, plan the aggregation-tree job DAG,
enqueue the leaves, await completion, finalize.

Reference role: city_rollup_core_orchestrator (SURVEY.md §3.2/§3.3) —
CityOrchestratorBlockPlanner::process_requests (op application + witness
emission, op_processor.rs) + plan_jobs (DAG wiring, job_planner.rs).

Transition semantics match the new op circuits (op_circuits.py): per-tree
spans, combined H(user,other) commitments for two-tree ops, and the block
circuits' chaining of family spans into (old city root -> new city root).
Odd aggregation levels are padded with dummy (identity-transition) leaf
jobs instead of the reference's carried-up nodes — same proofs-per-level
shape, simpler ID arithmetic.

Counterpart of the reference's ``rollup/orchestrator.py``: a copy, with one
repair in the L1 context's job DAG. The reference installs each input's
sighash edges under its jobs' group counter (``counter_id()``: task index
0), so every input's edge lands on input 0's counter, and the Groth16 edge
(final GL -> wrap) on the final GL's join counter: a block with more than
one input or with the Groth16 wrap never releases all its jobs, nor its
completion notification. Here each input's edges have counters of their
own (``_input_counter``); for one input without the wrap they are the
reference's.
"""

from __future__ import annotations

import dataclasses

from ..core import poseidon_host
from ..crypto import felts as feltenc
from . import btc
from .circuits import encode_witness
from .city_store import CityStore
from .job_id import CircuitType, JobID, JobTopic
from .proof_store import QProofStore
from .queues import Q_JOB, QueueHub
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


# -- host twins of the in-circuit signature action hashes ----------------------
# (what a user signs; op_gadgets.sig_action_hash / op_circuits pin these)

def transfer_action_hash(params, sender_uid: int, new_nonce: int,
                         receiver_uid: int, value: int) -> list[int]:
    from . import op_gadgets as og
    return poseidon_host.hash_no_pad(
        [params.network_magic, sender_uid, og.SIG_ACTION_TRANSFER_MAGIC,
         new_nonce, receiver_uid, value])


def withdrawal_action_hash(params, uid: int, new_nonce: int, address: tuple,
                           value: int) -> list[int]:
    from . import op_gadgets as og
    return poseidon_host.hash_no_pad(
        [params.network_magic, uid, og.SIG_ACTION_ADD_WITHDRAWAL_MAGIC,
         new_nonce] + list(address) + [value, params.withdrawal_fee])


def claim_action_hash(params, uid: int, txid224: tuple,
                      value: int) -> list[int]:
    from . import op_gadgets as og
    return poseidon_host.hash_no_pad(
        [params.network_magic, uid, og.SIG_ACTION_CLAIM_DEPOSIT_MAGIC, 0] +
        list(txid224) + [value, params.deposit_fee])


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
    # sighash chain (set when planned with an L1 context)
    block_tx: object = None
    covenant_script: bytes = b""
    hints: list = dataclasses.field(default_factory=list)
    sighash_final_jobs: list = dataclasses.field(default_factory=list)
    groth16_jobs: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class L1BlockContext:
    """The L1 view the sighash finalizer needs: the previous block's
    transaction (whose output 0 is the covenant being spent) and the
    deposit funding transactions confirmed since (reference:
    get_confirmed_funding_transactions + create_hints_for_block,
    actors/simple.rs:44-125)."""
    spend_cfg: btc.BlockSpendCoreConfig
    script_body: bytes
    prev_block_tx: btc.BTCTransaction
    deposit_txs: list = dataclasses.field(default_factory=list)
    with_groth16: bool = False


def requests_from_deposit_txs(deposit_txs: list, start_id: int) -> list:
    """Derive AddDeposit requests from funding transactions EXACTLY as the
    sighash circuit will parse them (btc.parse_deposits semantics), so the
    add_deposit op's event leaves match the introspection deposit hashes."""
    out = []
    for k, tx in enumerate(deposit_txs):
        pk = tx.inputs[0].script[-33:]
        out.append(AddDeposit(
            deposit_id=start_id + k,
            txid224=tuple(feltenc.hash256_to_hash224(tx.txid())),
            public_key=tuple(feltenc.bytes33_to_felts(pk)),
            value=tx.outputs[0].value))
    return out


def make_genesis_block_tx(cfg: btc.BlockSpendCoreConfig, script_body: bytes,
                          genesis_state: bytes, balance: int
                          ) -> btc.BTCTransaction:
    """A synthetic previous-block transaction for block 1: one funding
    input (placeholder witness script of the covenant size) and the
    covenant output holding the rollup balance (reference: genesis setup,
    orchestrator src/lib.rs:120-186)."""
    script = bytes([btc.OP_PUSHBYTES_32]) + genesis_state + script_body
    return btc.BTCTransaction(
        version=cfg.version,
        inputs=[btc.BTCTransactionInput(
            hash=b"\x00" * 32, index=0,
            script=b"\x00" * cfg.block_funding_script_size)],
        outputs=[btc.BTCTransactionOutput(
            value=balance,
            script=btc.p2sh_script(btc.p2sh_address_of(script)))],
        locktime=cfg.locktime)


def _input_counter(job: JobID) -> JobID:
    """The counter cell of one L1 input's edge: `job`'s group counter at
    the job's own task index (the input's), so that inputs do not share
    it."""
    return dataclasses.replace(job.counter_id(), task_index=job.task_index)


class Orchestrator:
    def __init__(self, city: CityStore, store: QProofStore, hub: QueueHub,
                 params=None):
        from .circuits import DEFAULT_PARAMS
        self.city = city
        self.store = store
        self.hub = hub
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
    def plan_block(self, checkpoint_id: int, requests: BlockRequests,
                   l1_context: L1BlockContext | None = None) -> PlannedBlock:
        """Apply ops, build the aggregation DAG, and (with an L1 context)
        plan the per-tx-input sighash -> final-GL -> Groth16 chain gating
        the completion notification (job_planner.rs:14-56 +
        sighash/finalizer.rs:19-66)."""
        cp = checkpoint_id
        city = self.city
        if l1_context is not None:
            # validate BEFORE any op mutates the store: a withdrawal whose
            # address flag produces a script size the covenant shape can't
            # carry would otherwise crash _finalize_sighashes after the
            # state is half-applied (one bad request = a dead block)
            want = l1_context.spend_cfg.withdrawal_output_script_size

            def _check_flag(wid, limb2):
                flag = (int(limb2) >> 48) & 0xFFFF
                size = 23 if flag else 25
                if size != want:
                    raise ValueError(
                        f"withdrawal {wid}: script size {size} (flag "
                        f"{flag}) does not match the covenant's "
                        f"{want}-byte withdrawal outputs")

            for r in requests.add_withdrawals:
                _check_flag(r.withdrawal_id, r.address[2])
            for r in requests.process_withdrawals:
                leaf = city.withdrawal_tree.get_leaf(r.withdrawal_id, cp)
                _check_flag(r.withdrawal_id, leaf[3])
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
        if l1_context is None:
            self.store.write_next_jobs([final], [notify],
                                       counter_id=notify.counter_id())
            return planned
        self._finalize_sighashes(planned, l1_context)
        return planned

    # -- sighash finalizer (sighash/finalizer.rs:19-66 twin) -------------------
    def _finalize_sighashes(self, planned: PlannedBlock,
                            ctx: L1BlockContext):
        """Assemble the block transaction from the planned events, build a
        BlockSpendIntrospectionHint per tx input, and chain
        SIGHASH_INTROSPECTION -> SIGHASH_WRAPPER -> (with the transition
        proof) SIGHASH_FINAL_GL [-> WRAP_FINAL_SIGHASH_PROOF_BLS12381] per
        input, all gating the completion notification."""
        cfg = ctx.spend_cfg
        cp = planned.checkpoint_id
        from ..crypto.qhashout import QHashOut

        old_bytes = QHashOut(tuple(planned.start_city_root)).to_le_bytes()
        new_bytes = QHashOut(tuple(planned.end_city_root)).to_le_bytes()
        cur_script = bytes([btc.OP_PUSHBYTES_32]) + old_bytes + \
            ctx.script_body
        next_script = bytes([btc.OP_PUSHBYTES_32]) + new_bytes + \
            ctx.script_body
        assert len(cur_script) == cfg.block_sighash_script_size

        dep_total = sum(tx.outputs[0].value for tx in ctx.deposit_txs)
        cur_bal = ctx.prev_block_tx.outputs[0].value
        wd_total = sum(int(ev[0]) for ev in planned.withdrawal_events)
        next_bal = cur_bal + dep_total - wd_total
        assert next_bal >= 0, "block overdraws the covenant"

        outputs = [btc.BTCTransactionOutput(
            value=next_bal,
            script=btc.p2sh_script(btc.p2sh_address_of(next_script)))]
        for ev in planned.withdrawal_events:
            pkh, flag = feltenc.felts_to_hash160(list(ev[1:]))
            script = btc.p2sh_script(pkh) if flag else \
                btc.p2pkh_script(pkh)
            assert len(script) == cfg.withdrawal_output_script_size, \
                "withdrawal script size does not match the covenant shape"
            outputs.append(btc.BTCTransactionOutput(value=int(ev[0]),
                                                    script=script))

        fundings = [ctx.prev_block_tx] + list(ctx.deposit_txs)
        inputs = [btc.BTCTransactionInput(hash=f.txid(), index=0, script=b"")
                  for f in fundings]
        block_tx = btc.BTCTransaction(version=cfg.version, inputs=inputs,
                                      outputs=outputs, locktime=cfg.locktime)
        planned.block_tx = block_tx
        planned.covenant_script = cur_script

        terminals: list[JobID] = []
        for i in range(len(inputs)):
            pre = btc.sighash_preimage(block_tx, i, cur_script,
                                       cfg.sighash_type)
            hint = btc.BlockSpendIntrospectionHint(
                sighash_preimage=pre,
                last_block_spend_index=cfg.block_spend_index,
                block_spend_index=cfg.block_spend_index,
                current_spend_index=i,
                funding_transactions=fundings,
                next_block_redeem_script=next_script)
            planned.hints.append(hint)

            intro = JobID(JobTopic.GENERATE_STANDARD_PROOF, cp,
                          int(CircuitType.SIGHASH_INTROSPECTION),
                          group_id=110, task_index=i)
            self.store.set_bytes(intro.input_witness_id(),
                                 encode_witness({"hint": hint.to_dict()}))
            swrap = JobID(JobTopic.GENERATE_STANDARD_PROOF, cp,
                          int(CircuitType.SIGHASH_WRAPPER),
                          group_id=111, task_index=i)
            self.store.set_bytes(swrap.input_witness_id(), encode_witness({
                "child": intro.hex(),
                "gid": hint.gadget_id().to_felt()}))
            fin = JobID(JobTopic.GENERATE_STANDARD_PROOF, cp,
                        int(CircuitType.SIGHASH_FINAL_GL),
                        group_id=112, task_index=i)
            self.store.set_bytes(fin.input_witness_id(), encode_witness({
                "transition": planned.final_job.hex(),
                "wrapper": swrap.hex(), "cur_bal": cur_bal,
                "next_bal": next_bal, "spend_idx": i}))
            self.store.write_next_jobs([intro], [swrap],
                                       counter_id=_input_counter(intro))
            self.store.write_next_jobs([planned.final_job, swrap], [fin],
                                       counter_id=_input_counter(fin))
            planned.leaf_jobs.append(intro)
            planned.sighash_final_jobs.append(fin)
            planned.num_jobs += 3
            if ctx.with_groth16:
                g16 = JobID(JobTopic.GENERATE_GROTH16_PROOF, cp,
                            int(CircuitType.
                                WRAP_FINAL_SIGHASH_PROOF_BLS12381),
                            group_id=113, task_index=i)
                self.store.set_bytes(g16.input_witness_id(),
                                     encode_witness({"final": fin.hex()}))
                self.store.write_next_jobs([fin], [g16],
                                           counter_id=_input_counter(g16))
                planned.groth16_jobs.append(g16)
                planned.num_jobs += 1
                terminals.append(g16)
            else:
                terminals.append(fin)
        self.store.write_next_jobs(terminals, [planned.notify_job],
                                   counter_id=planned.notify_job.counter_id())

    def enqueue(self, planned: PlannedBlock):
        for job in planned.leaf_jobs:
            self.hub.dispatch(Q_JOB, job.to_bytes())

    # -- L1 transaction assembly (step_2, actors/simple.rs:348-389) -----------
    def assemble_l1_transaction(self, planned: PlannedBlock,
                                verifier_data: bytes = b"",
                                link=None) -> btc.BTCTransaction:
        """Read the per-input CityGroth16ProofData from the proof store,
        build the P2SH witness scripts (proof pushes + verifier data + the
        covenant redeem script), fill the block transaction's input
        scripts, and broadcast via the L1 link if given."""
        import json as _json
        from . import groth16_wrap as g16
        assert planned.block_tx is not None, "block planned without L1 ctx"
        assert planned.groth16_jobs, "block planned without groth16 wraps"
        if link is not None and not (g16.GROTH16_DISABLED_DEV_MODE
                                     or g16.GROTH16_WRAP_ATTESTATION_DEV_MODE):
            raise RuntimeError(
                "refusing to broadcast: the Groth16 wrap statement is an "
                "attestation (no in-R1CS Goldilocks verification) and MUST "
                "NOT be relied on for on-chain security; set "
                "groth16_wrap.GROTH16_WRAP_ATTESTATION_DEV_MODE = True to "
                "acknowledge, or GROTH16_DISABLED_DEV_MODE for OP_NOP mode")
        new_inputs = []
        for i, inp in enumerate(planned.block_tx.inputs):
            raw = self.store.get_bytes(
                planned.groth16_jobs[i].output_proof_id())
            assert raw is not None, f"missing groth16 wrap for input {i}"
            pd = _json.loads(raw.decode())["proof_data"]
            witness = btc.encode_binary_witness_script_for_p2sh(
                planned.covenant_script,
                [bytes.fromhex(pd["pi_a"]), bytes.fromhex(pd["pi_b_a0"]),
                 bytes.fromhex(pd["pi_b_a1"]), bytes.fromhex(pd["pi_c"]),
                 verifier_data])
            new_inputs.append(btc.BTCTransactionInput(
                hash=inp.hash, index=inp.index, script=witness,
                sequence=inp.sequence))
        final_tx = btc.BTCTransaction(
            version=planned.block_tx.version, inputs=new_inputs,
            outputs=planned.block_tx.outputs,
            locktime=planned.block_tx.locktime)
        if link is not None:
            link.send_transaction(final_tx)
        return final_tx

    # -- finalize ------------------------------------------------------------------
    def finalize(self, planned: PlannedBlock, toolbox) -> bool:
        """Verify the block's final state-transition proof against the
        claimed city-root move (step_2 twin, without the L1 transaction)."""
        from .circuits import decode_proof
        raw = self.store.get_proof(planned.final_job.output_proof_id())
        if raw is None:
            return False
        proof = decode_proof(raw)
        pis = [int(x) for x in proof.public_inputs]
        if pis[0:4] != [int(x) for x in planned.start_city_root]:
            return False
        if pis[4:8] != [int(x) for x in planned.end_city_root]:
            return False
        return toolbox.verify_block_proof("transition", proof)
