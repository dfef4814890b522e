"""The rollup's proving circuits, with real in-circuit semantics:

- six op circuits that verify delta-Merkle state updates in-circuit and
  expose ``[allowed_circuit_hashes_root(4), state_transition_hash(4)]``
  (shape A, 8 PIs) or ``[..., events_hash(4)]`` (shape B, 12 PIs) as public
  inputs (reference: city_rollup_circuit/src/block_circuits/ops/*,
  SURVEY.md §2.3);
- dummy circuits proving identity transitions (state_transition_dummy);
- the recursive tree aggregation circuits that verify two child proofs of
  *their own shape* via the in-circuit FRI verifier, with the
  fingerprint-enum admission check (AggStateTransitionCircuit,
  city_common_circuit/src/treeprover/aggregation/state_transition/mod.rs,
  SURVEY.md §2.7);
- the block root aggregators + block state transition circuit
  (SURVEY.md §2.4).

Shape sharing (the self-recursion invariant): every circuit of one family
is built with the same declared gate set and padded to the same degree so
they produce interchangeable proofs — the aggregator accepts both leaf
proofs and its own recursive proofs against ONE CommonData (the reference
pins this with add_city_common_gates + pad_circuit_degree,
city_common_circuit/src/builder/pad_circuit.rs:25-56). `build_shape_family`
finds the fixed point (gate-set closure + degree) automatically.

Counterpart of the reference's ``rollup/op_circuits.py``, on the port's
circuit builder: the same makers give the same rows.
"""

from __future__ import annotations

import dataclasses

from ..core import poseidon_host
from ..snark import recursion
from ..snark.circuit import (CircuitBuilder, CircuitConfig, CircuitData,
                             CommonData, PartialWitness,
                             common_shape_key, compute_selector_groups)
from . import op_gadgets as og
from .city_store import CLAIMED_MARKER

ZERO4 = (0, 0, 0, 0)


@dataclasses.dataclass
class RollupParams:
    """Build-time knobs. Production mirrors rollup_constants.rs (heights 32);
    tests shrink heights + FRI like the reference's dev-mode escapes.

    `sig_wrapper`: CircuitData of the ZK-signature wrapper circuit
    (zk_signature.ZKSignatureWrapperCircuit). When set, the user-authorized
    ops (l2_transfer, add_l1_withdrawal) recursively verify a wrapper proof
    binding (sender pk, action hash) in-circuit — the reference's
    "verifies inner proof" column in SURVEY.md §2.3. `l1_sig_circuit` plays
    the same role for claim_l1_deposit's secp256k1 signature proof."""
    config: CircuitConfig
    user_tree_height: int = 32
    deposit_tree_height: int = 32
    withdrawal_tree_height: int = 32
    network_magic: int = 0xD06E_0001
    deposit_fee: int = 100_000
    withdrawal_fee: int = 100_000
    sig_wrapper: object = None          # CircuitData | None
    l1_sig_circuit: object = None       # CircuitData | None


def _hash2(a, b):
    return tuple(poseidon_host.two_to_one(list(a), list(b)))


# ===========================================================================
# Op circuit makers. Each returns (targets: dict, setter: fn(pw, wit: dict)).
# `allowed_root` is a witness (the planner pins it to the family's
# TPCircuitFingerprintConfig.allowed_circuit_hashes_root).
# ===========================================================================

def _register_pis(b, allowed, transition, events=None):
    b.register_public_inputs(list(allowed))
    b.register_public_inputs(list(transition))
    if events is not None:
        b.register_public_inputs(list(events))


def _verify_sig_proof(b, sig_data, pk, action):
    """Recursively verify a ZK-signature wrapper proof binding (pk, action)
    under the wrapper's constant verifier data (the reference verifies the
    ZKSignatureWrapperCircuit proof inside l2_transfer/add_l1_withdrawal,
    ops/l2_transfer/circuit.rs:158-183). Returns the proof targets."""
    pt = recursion.add_virtual_proof(b, sig_data.common)
    vdt = recursion.constant_verifier_data(b, sig_data.verifier)
    recursion.verify_proof_gadget(b, pt, sig_data.common, vdt)
    b.connect_hashes(pt.public_inputs[0:4], list(pk))
    b.connect_hashes(pt.public_inputs[4:8], list(action))
    return pt


def make_register_user(b: CircuitBuilder, p: RollupParams):
    """User tree: leaf 2*uid+1 <- pk, previously empty
    (ops/register_user/mod.rs)."""
    allowed = b.add_virtual_hash()
    uid = b.add_virtual_target()
    dm = og.add_delta_merkle_gadget(b, p.user_tree_height)
    for j in range(4):
        b.assert_zero(dm.old_value[j])        # slot must be empty
    # index == 2*uid + 1
    b.connect(dm.index, b.add_const(b.mul_const(2, uid), 1))
    transition = b.hash_two_to_one(dm.old_root, dm.new_root)
    _register_pis(b, allowed, transition)

    def setter(pw: PartialWitness, wit: dict):
        pw.set(uid, wit["user_id"])
        og.set_delta_merkle_witness(pw, dm, wit["user_delta"])
        for t, v in zip(allowed, wit["allowed_root"]):
            pw.set(t, v)

    return {"allowed": allowed}, setter


def make_claim_l1_deposit(b: CircuitBuilder, p: RollupParams):
    """Deposit marked claimed + user balance += value - fee; combined 2-tree
    transition H(H(u0,d0), H(u1,d1)) (ops/claim_l1_deposit/mod.rs,
    state/user/claim_l1_deposit.rs)."""
    allowed = b.add_virtual_hash()
    uid = b.add_virtual_target()
    txid224 = b.add_virtual_hash()
    pk = b.add_virtual_targets(9)       # 9-felt compressed L1 pubkey
    value = b.add_virtual_target()

    dep = og.add_delta_merkle_gadget(b, p.deposit_tree_height)
    dep_leaf = og.deposit_leaf_hash(b, txid224, pk, value)
    b.connect_hashes(dep.old_value, dep_leaf)
    for j in range(4):
        b.connect(dep.new_value[j], b.constant(CLAIMED_MARKER[j]))

    user = og.add_delta_merkle_gadget(b, p.user_tree_height)
    st = og.decode_user_leaf(b, user.old_value)
    fee = b.constant(p.deposit_fee)
    claim = b.sub(value, fee)
    b.range_check(claim, og.BALANCE_BITS)          # value >= fee
    new_bal = b.add(st.balance, claim)
    b.range_check(new_bal, og.BALANCE_BITS)
    b.connect_hashes(user.new_value,
                     og.user_leaf(b, new_bal, st.nonce))
    b.connect(user.index, b.mul_const(2, uid))

    # the L1 key's signature action commitment (verified against the
    # secp256k1 signature proof; exposed for the wallet/prover to target)
    action = og.sig_action_hash(
        b, p.network_magic, uid, og.SIG_ACTION_CLAIM_DEPOSIT_MAGIC,
        b.zero(), list(txid224) + [value, fee])
    # combined = Poseidon(pk9 ∥ action) — the exact public input the L1
    # (secp256k1) signature circuit exposes (l1_signature.py
    # combined_hash_gadget / crypto.secp256k1.combined_action_hash)
    combined = b.hash_n_to_hash_no_pad(list(pk) + list(action))

    # the L1 key's signature proof: a circuit exposing [combined_hash(4)]
    # as its public inputs (secp256k1 ECDSA proof in the reference; the
    # proof shape is pluggable via params so the zk-wrapper can stand in
    # until the secp gadget is wired — ops/claim_l1_deposit/mod.rs).
    sig_pt = None
    if p.l1_sig_circuit is not None:
        pt = recursion.add_virtual_proof(b, p.l1_sig_circuit.common)
        vdt = recursion.constant_verifier_data(b, p.l1_sig_circuit.verifier)
        recursion.verify_proof_gadget(b, pt, p.l1_sig_circuit.common, vdt)
        b.connect_hashes(pt.public_inputs[0:4], combined)
        sig_pt = pt

    start = b.hash_two_to_one(user.old_root, dep.old_root)
    end = b.hash_two_to_one(user.new_root, dep.new_root)
    transition = b.hash_two_to_one(start, end)
    _register_pis(b, allowed, transition)

    def setter(pw: PartialWitness, wit: dict):
        pw.set(uid, wit["user_id"])
        for t, v in zip(txid224, wit["txid224"]):
            pw.set(t, v)
        for t, v in zip(pk, wit["public_key"]):
            pw.set(t, v)
        pw.set(value, wit["value"])
        og.set_delta_merkle_witness(pw, dep, wit["deposit_delta"])
        og.set_delta_merkle_witness(pw, user, wit["user_delta"])
        for t, v in zip(allowed, wit["allowed_root"]):
            pw.set(t, v)
        if sig_pt is not None:
            recursion.set_proof_witness(pw, sig_pt, wit["l1_signature_proof"])

    return {"allowed": allowed, "combined_sig_hash": combined}, setter


def make_l2_transfer(b: CircuitBuilder, p: RollupParams):
    """sender -v (nonce bump), receiver +v; chained user-tree deltas
    (ops/l2_transfer/circuit.rs:113-235)."""
    allowed = b.add_virtual_hash()
    sender_uid = b.add_virtual_target()
    recv_uid = b.add_virtual_target()
    value = b.add_virtual_target()
    b.range_check(value, og.BALANCE_BITS)

    snd = og.add_delta_merkle_gadget(b, p.user_tree_height)
    s0 = og.decode_user_leaf(b, snd.old_value)
    new_sbal = b.sub(s0.balance, value)
    b.range_check(new_sbal, og.BALANCE_BITS)       # balance >= value
    new_nonce = b.add_const(s0.nonce, 1)
    b.connect_hashes(snd.new_value, og.user_leaf(b, new_sbal, new_nonce))
    b.connect(snd.index, b.mul_const(2, sender_uid))

    rcv = og.add_delta_merkle_gadget(b, p.user_tree_height)
    r0 = og.decode_user_leaf(b, rcv.old_value)
    new_rbal = b.add(r0.balance, value)
    b.range_check(new_rbal, og.BALANCE_BITS)
    b.connect_hashes(rcv.new_value, og.user_leaf(b, new_rbal, r0.nonce))
    b.connect(rcv.index, b.mul_const(2, recv_uid))

    # the two deltas chain through the middle root
    b.connect_hashes(snd.new_root, rcv.old_root)

    action = og.sig_action_hash(
        b, p.network_magic, sender_uid, og.SIG_ACTION_TRANSFER_MAGIC,
        new_nonce, [recv_uid, value])

    # sender's stored pk is the level-0 sibling of the balance leaf (leaf
    # 2*uid+1, written by register_user); the signature wrapper proof must
    # bind exactly (that pk, this action hash).
    sig_pt = None
    if p.sig_wrapper is not None:
        sig_pt = _verify_sig_proof(b, p.sig_wrapper, snd.siblings[0], action)

    transition = b.hash_two_to_one(snd.old_root, rcv.new_root)
    _register_pis(b, allowed, transition)

    def setter(pw: PartialWitness, wit: dict):
        pw.set(sender_uid, wit["sender_id"])
        pw.set(recv_uid, wit["receiver_id"])
        pw.set(value, wit["value"])
        og.set_delta_merkle_witness(pw, snd, wit["sender_delta"])
        og.set_delta_merkle_witness(pw, rcv, wit["receiver_delta"])
        for t, v in zip(allowed, wit["allowed_root"]):
            pw.set(t, v)
        if sig_pt is not None:
            recursion.set_proof_witness(pw, sig_pt, wit["signature_proof"])

    return {"allowed": allowed, "action_hash": action}, setter


def make_add_l1_withdrawal(b: CircuitBuilder, p: RollupParams):
    """user -(v+fee) with nonce bump + withdrawal-tree append
    (ops/add_l1_withdrawal/mod.rs)."""
    allowed = b.add_virtual_hash()
    uid = b.add_virtual_target()
    address = b.add_virtual_targets(3)  # 3-limb hash160 packing
    value = b.add_virtual_target()
    b.range_check(value, og.BALANCE_BITS)

    user = og.add_delta_merkle_gadget(b, p.user_tree_height)
    st = og.decode_user_leaf(b, user.old_value)
    fee = b.constant(p.withdrawal_fee)
    debit = b.add(value, fee)
    new_bal = b.sub(st.balance, debit)
    b.range_check(new_bal, og.BALANCE_BITS)
    new_nonce = b.add_const(st.nonce, 1)
    b.connect_hashes(user.new_value, og.user_leaf(b, new_bal, new_nonce))
    b.connect(user.index, b.mul_const(2, uid))

    wd = og.add_delta_merkle_gadget(b, p.withdrawal_tree_height)
    for j in range(4):
        b.assert_zero(wd.old_value[j])
    b.connect_hashes(wd.new_value, og.withdrawal_leaf_hash(b, address,
                                                           value))

    action = og.sig_action_hash(
        b, p.network_magic, uid, og.SIG_ACTION_ADD_WITHDRAWAL_MAGIC,
        new_nonce, list(address) + [value, b.constant(p.withdrawal_fee)])

    sig_pt = None
    if p.sig_wrapper is not None:
        sig_pt = _verify_sig_proof(b, p.sig_wrapper, user.siblings[0],
                                   action)

    start = b.hash_two_to_one(user.old_root, wd.old_root)
    end = b.hash_two_to_one(user.new_root, wd.new_root)
    transition = b.hash_two_to_one(start, end)
    _register_pis(b, allowed, transition)

    def setter(pw: PartialWitness, wit: dict):
        pw.set(uid, wit["user_id"])
        for t, v in zip(address, wit["address"]):
            pw.set(t, v)
        pw.set(value, wit["value"])
        og.set_delta_merkle_witness(pw, user, wit["user_delta"])
        og.set_delta_merkle_witness(pw, wd, wit["withdrawal_delta"])
        for t, v in zip(allowed, wit["allowed_root"]):
            pw.set(t, v)
        if sig_pt is not None:
            recursion.set_proof_witness(pw, sig_pt, wit["signature_proof"])

    return {"allowed": allowed, "action_hash": action}, setter


def make_process_l1_withdrawal(b: CircuitBuilder, p: RollupParams):
    """Withdrawal marked complete; emits the withdrawal leaf as an event
    (shape B — ops/process_l1_withdrawal/mod.rs)."""
    allowed = b.add_virtual_hash()
    wd = og.add_delta_merkle_gadget(b, p.withdrawal_tree_height)
    for j in range(4):
        b.assert_zero(wd.new_value[j])            # cleared
    transition = b.hash_two_to_one(wd.old_root, wd.new_root)
    _register_pis(b, allowed, transition, events=wd.old_value)

    def setter(pw: PartialWitness, wit: dict):
        og.set_delta_merkle_witness(pw, wd, wit["withdrawal_delta"])
        for t, v in zip(allowed, wit["allowed_root"]):
            pw.set(t, v)

    return {"allowed": allowed}, setter


def make_add_l1_deposit(b: CircuitBuilder, p: RollupParams):
    """Deposit-tree append; emits the deposit leaf as an event
    (shape B — ops/add_l1_deposit/mod.rs)."""
    allowed = b.add_virtual_hash()
    txid224 = b.add_virtual_hash()
    pk = b.add_virtual_targets(9)       # 9-felt compressed L1 pubkey
    value = b.add_virtual_target()
    dep = og.add_delta_merkle_gadget(b, p.deposit_tree_height)
    for j in range(4):
        b.assert_zero(dep.old_value[j])
    leaf = og.deposit_leaf_hash(b, txid224, pk, value)
    b.connect_hashes(dep.new_value, leaf)
    transition = b.hash_two_to_one(dep.old_root, dep.new_root)
    _register_pis(b, allowed, transition, events=leaf)

    def setter(pw: PartialWitness, wit: dict):
        for t, v in zip(txid224, wit["txid224"]):
            pw.set(t, v)
        for t, v in zip(pk, wit["public_key"]):
            pw.set(t, v)
        pw.set(value, wit["value"])
        og.set_delta_merkle_witness(pw, dep, wit["deposit_delta"])
        for t, v in zip(allowed, wit["allowed_root"]):
            pw.set(t, v)

    return {"allowed": allowed}, setter


def make_dummy(with_events: bool):
    """Identity transition H(x, x) (state_transition_dummy twin): the
    stand-in proof for empty op sets and leaf-count padding."""

    def maker(b: CircuitBuilder, p: RollupParams):
        allowed = b.add_virtual_hash()
        x = b.add_virtual_hash()
        transition = b.hash_two_to_one(x, x)
        events = [b.zero()] * 4 if with_events else None
        _register_pis(b, allowed, transition, events=events)

        def setter(pw: PartialWitness, wit: dict):
            for t, v in zip(x, wit["state_root"]):
                pw.set(t, v)
            for t, v in zip(allowed, wit["allowed_root"]):
                pw.set(t, v)

        return {"allowed": allowed}, setter

    return maker


# ===========================================================================
# Tree aggregation circuit (self-recursive)
# ===========================================================================

def make_tree_agg(with_events: bool):
    """Verifies two child proofs of its OWN shape; children's verifier-data
    fingerprint must one-hot-match {leaf, agg, dummy}; chains left.end ==
    right.start; outputs [allowed, H(left.start, right.end)(, H(ev_l, ev_r))].
    (AggStateTransitionCircuit, state_transition/mod.rs:118-305 — the
    fingerprint enum is verify_proof_with_fingerprint_enum,
    builder/verify.rs:69-83.)"""

    def maker(b: CircuitBuilder, child_common: CommonData, p: RollupParams):
        leaf_fp = b.add_virtual_hash()
        agg_fp = b.add_virtual_hash()
        dummy_fp = b.add_virtual_hash()
        allowed = b.hash_two_to_one(
            b.hash_two_to_one(leaf_fp, agg_fp), dummy_fp)

        sides = []
        for _ in range(2):
            pt = recursion.add_virtual_proof(b, child_common)
            vdt = recursion.add_virtual_verifier_data(b, child_common)
            fp = recursion.fingerprint_gadget(b, vdt)
            # one-hot fingerprint enum
            sels = [b.add_virtual_target() for _ in range(3)]
            ssum = b.zero()
            for s in sels:
                b.assert_zero(b.mul(s, b.add_const(s, (1 << 64) - (1 << 32))))
                ssum = b.add(ssum, s)
            b.connect(ssum, b.one())
            for j in range(4):
                want = b.mul(sels[0], leaf_fp[j])
                want = b.mul_add(sels[1], agg_fp[j], want)
                want = b.mul_add(sels[2], dummy_fp[j], want)
                b.connect(fp[j], want)
            b.connect_hashes(pt.public_inputs[0:4], allowed)
            start = b.add_virtual_hash()
            end = b.add_virtual_hash()
            b.connect_hashes(b.hash_two_to_one(start, end),
                             pt.public_inputs[4:8])
            recursion.verify_proof_gadget(b, pt, child_common, vdt)
            sides.append({"pt": pt, "vdt": vdt, "sels": sels,
                          "start": start, "end": end})

        b.connect_hashes(sides[0]["end"], sides[1]["start"])
        transition = b.hash_two_to_one(sides[0]["start"], sides[1]["end"])
        events = None
        if with_events:
            events = b.hash_two_to_one(sides[0]["pt"].public_inputs[8:12],
                                       sides[1]["pt"].public_inputs[8:12])
        b.register_public_inputs(list(allowed))
        b.register_public_inputs(list(transition))
        if events is not None:
            b.register_public_inputs(list(events))

        targets = {"leaf_fp": leaf_fp, "agg_fp": agg_fp,
                   "dummy_fp": dummy_fp, "sides": sides}
        return targets

    return maker


# ===========================================================================
# Shape-family builder: fixed point over (gate set, degree)
# ===========================================================================

@dataclasses.dataclass
class BuiltCircuit:
    name: str
    data: CircuitData
    targets: object
    setter: object
    fingerprint: tuple = None       # set by the toolbox after build


@dataclasses.dataclass
class ShapeFamily:
    common: CommonData              # the one shared proof shape
    leaves: dict                    # name -> BuiltCircuit
    dummy: BuiltCircuit
    agg: BuiltCircuit


def _canonical_gates(gate_objs: dict) -> list:
    return [gate_objs[k] for k in sorted(gate_objs)]


def build_shape_family(params: RollupParams, leaf_makers: dict,
                       with_events: bool, min_log_n: int = 0,
                       device=None) -> ShapeFamily:
    """Build a family (leaf ops + dummy + self-recursive aggregator) that
    all share one CommonData. Iterates until the aggregator built against
    the candidate shape reproduces that exact shape. The members' proofs
    run on `device` (as `CircuitBuilder.build`'s)."""
    config = params.config
    num_pis = 12 if with_events else 8
    dummy_maker = make_dummy(with_events)
    agg_maker = make_tree_agg(with_events)

    # pass 1: leaves standalone -> initial gate union + degree
    gate_objs: dict = {}
    log_d = min_log_n
    for name, mk in leaf_makers.items():
        b = CircuitBuilder(config)
        mk(b, params)
        data = b.build()
        for g in data.common.gates:
            gate_objs.setdefault(g.key, g)
        log_d = max(log_d, data.common.log_n)

    # pass 2 (iterate): candidate shape -> aggregator -> check fixpoint.
    # First a probe build (no declared set) harvests the aggregator's gate
    # usage against the candidate; once the union is stable, a declared
    # build must reproduce the candidate shape exactly.
    agg_data = agg_targets = None
    for _ in range(10):
        gates = _canonical_gates(gate_objs)
        cand = CommonData(config=config, log_n=log_d, gates=gates,
                          selector_groups=compute_selector_groups(gates,
                                                                  config),
                          num_public_inputs=num_pis)
        b = CircuitBuilder(config)
        agg_maker(b, cand, params)
        try:
            probe = b.build(min_log_n=log_d)
        except AssertionError:
            # too many rows for the candidate degree: grow and retry, at
            # once to the degree these rows need (the reference steps one
            # degree at a time; the degrees it steps over fail the same
            # way, since a deeper child shape only adds verifier rows)
            n_rows = len(b.rows) + config.num_blinding_rows
            log_d = max(log_d + 1, (n_rows - 1).bit_length())
            continue
        new_keys = {g.key for g in probe.common.gates} - set(gate_objs)
        if new_keys:
            for g in probe.common.gates:
                gate_objs.setdefault(g.key, g)
            continue
        b2 = CircuitBuilder(config)
        b2.declare_gates(list(gates))
        agg_targets = agg_maker(b2, cand, params)
        agg_data = b2.build(min_log_n=log_d, device=device)
        assert common_shape_key(agg_data.common) == common_shape_key(cand), \
            "aggregator diverged from its own candidate shape"
        break
    else:
        raise RuntimeError("shape family failed to converge")

    gates = _canonical_gates(gate_objs)
    shared = agg_data.common

    def build_member(name, mk):
        bb = CircuitBuilder(config)
        bb.declare_gates(list(gates))
        t, s = mk(bb, params)
        d = bb.build(min_log_n=log_d, device=device)
        assert common_shape_key(d.common) == common_shape_key(shared), \
            f"{name} diverged from the family shape"
        return BuiltCircuit(name=name, data=d, targets=t, setter=s)

    leaves = {name: build_member(name, mk)
              for name, mk in leaf_makers.items()}
    dummy = build_member("dummy", dummy_maker)
    agg = BuiltCircuit(name="agg", data=agg_data, targets=agg_targets,
                       setter=None)
    return ShapeFamily(common=shared, leaves=leaves, dummy=dummy, agg=agg)


# ===========================================================================
# Block-level circuits (one-off shapes; constant verifier data + 3-way
# constant fingerprint enums — SURVEY.md §2.4)
# ===========================================================================

@dataclasses.dataclass
class FamilyFps:
    """TPCircuitFingerprintConfig twin (treeprover/mod.rs:326-352)."""
    leaf: tuple
    agg: tuple
    dummy: tuple

    @property
    def allowed_root(self) -> tuple:
        return _hash2(_hash2(self.leaf, self.agg), self.dummy)

    def enum(self) -> list:
        return [self.leaf, self.agg, self.dummy]

    def as_dict(self) -> dict:
        return {"leaf_fp": self.leaf, "agg_fp": self.agg,
                "dummy_fp": self.dummy}


