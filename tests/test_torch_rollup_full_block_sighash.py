"""The rollup's L1 binding and user signatures end to end on the port, on
the CPU at FAST_TEST_PARAMS (slow: every proof of each block, the 2^17
sighash accelerator among them, on the plain PyTorch versions of the
kernels; hours of one CPU). The reference's own tests of these flows
(tests/test_full_block_sighash.py, tests/test_full_block.py::
test_full_block_with_signatures, tests/test_claim_deposit_e2e.py), on the
port; the city roots and the final-GL public inputs are those of the
reference's plan of the same block."""

import dataclasses
import random

import pytest
import torch

from city_rollup_tpu.rollup import btc as jbtc
from city_rollup_tpu.rollup import orchestrator as jom
from city_rollup_tpu.rollup.circuits import FAST_TEST_PARAMS as JFAST
from city_rollup_tpu.rollup.city_store import CityStore as JCityStore
from city_rollup_tpu.rollup.proof_store import MemoryProofStore as JStore
from city_rollup_tpu.rollup.queues import QueueHub as JHub
from city_rollup_tpu_torch.crypto import felts as feltenc
from city_rollup_tpu_torch.crypto import secp256k1 as curve
from city_rollup_tpu_torch.crypto.qhashout import QHashOut
from city_rollup_tpu_torch.rollup import btc
from city_rollup_tpu_torch.rollup import orchestrator as om
from city_rollup_tpu_torch.rollup.circuits import (FAST_TEST_PARAMS,
                                                   CircuitToolbox,
                                                   decode_proof,
                                                   encode_proof)
from city_rollup_tpu_torch.rollup.city_store import CityStore
from city_rollup_tpu_torch.rollup.job_id import CircuitType, JobID, JobTopic
from city_rollup_tpu_torch.rollup.l1_signature import L1DevSignatureCircuit
from city_rollup_tpu_torch.rollup.proof_store import MemoryProofStore
from city_rollup_tpu_torch.rollup.queues import Q_NOTIFICATIONS, QueueHub
from city_rollup_tpu_torch.rollup.sighash_toolbox import SigHashToolbox
from city_rollup_tpu_torch.rollup.wallet import CityMemoryWallet
from city_rollup_tpu_torch.rollup.worker import Worker
from city_rollup_tpu_torch.snark import verifier
from test_torch_rollup_plan import _as_ref


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _city(city_cls, p):
    return city_cls(user_tree_height=p.user_tree_height,
                    deposit_tree_height=p.deposit_tree_height,
                    withdrawal_tree_height=p.withdrawal_tree_height)


def _deposit_tx(covenant_script: bytes, value: int, rnd) -> btc.BTCTransaction:
    pk = b"\x02" + bytes(rnd.randrange(256) for _ in range(32))
    return btc.BTCTransaction(
        version=2,
        inputs=[btc.BTCTransactionInput(
            hash=bytes(rnd.randrange(256) for _ in range(32)), index=0,
            script=bytes(7) + pk)],
        outputs=[btc.BTCTransactionOutput(
            value=value,
            script=btc.p2sh_script(btc.p2sh_address_of(covenant_script)))],
        locktime=0)


def sighash_block(mod, btc_mod, city_cls, store_cls, hub_cls, params,
                  prev_tx, dep_tx, wd_addr):
    """The block of the reference's tests/test_full_block_sighash.py (a
    deposit, a withdrawal and its processing, over one funded user) planned
    with its L1 context by either package. Returns (planned, city, store,
    hub, orchestrator)."""
    city = _city(city_cls, params)
    city.register_user(0, 0, (1, 1, 1, 1))
    city.increment_user_balance(0, 0, 100_000 + params.withdrawal_fee)
    store, hub = store_cls(), hub_cls()
    orch = mod.Orchestrator(city, store, hub, params=params)
    reqs = mod.BlockRequests(
        add_deposits=mod.requests_from_deposit_txs([dep_tx], 0),
        add_withdrawals=[mod.AddWithdrawal(0, 0, wd_addr, 40_000)],
        process_withdrawals=[mod.ProcessWithdrawal(0)])
    ctx = mod.L1BlockContext(
        spend_cfg=btc_mod.dev_spend_cfg(), script_body=btc_mod.DEV_SCRIPT_BODY,
        prev_block_tx=prev_tx, deposit_txs=[dep_tx], with_groth16=False)
    return orch.plan_block(1, reqs, l1_context=ctx), city, store, hub, orch


@pytest.mark.slow
def test_full_block_with_sighash_chain():
    rnd = random.Random(41)
    p = FAST_TEST_PARAMS
    cfg, body = btc.dev_spend_cfg(), btc.DEV_SCRIPT_BODY
    genesis = _city(CityStore, p)
    genesis.register_user(0, 0, (1, 1, 1, 1))
    genesis.increment_user_balance(0, 0, 100_000 + p.withdrawal_fee)
    old_bytes = QHashOut(tuple(genesis.get_city_root(0))).to_le_bytes()
    cur_script = bytes([btc.OP_PUSHBYTES_32]) + old_bytes + body
    prev_tx = om.make_genesis_block_tx(cfg, body, old_bytes,
                                       balance=5_000_000)
    dep_tx = _deposit_tx(cur_script, 1_000_000, rnd)
    pkh = bytes(rnd.randrange(256) for _ in range(20))
    wd_addr = tuple(feltenc.hash160_to_felts(pkh, 0))            # p2pkh

    planned, city, store, hub, orch = sighash_block(
        om, btc, CityStore, MemoryProofStore, QueueHub, p, prev_tx, dep_tx,
        wd_addr)
    jplanned = sighash_block(
        jom, jbtc, JCityStore, JStore, JHub, JFAST,
        jbtc.BTCTransaction.parse(prev_tx.serialize()),
        jbtc.BTCTransaction.parse(dep_tx.serialize()), wd_addr)[0]
    assert (planned.start_city_root, planned.end_city_root) == \
        (jplanned.start_city_root, jplanned.end_city_root)
    assert planned.block_tx.serialize() == jplanned.block_tx.serialize()
    assert len(planned.hints) == 2                 # covenant + 1 deposit
    assert planned.block_tx.outputs[0].value == 5_000_000 + 1_000_000 - 40_000

    toolbox = CircuitToolbox(p, device="cpu")
    gids = [h.gadget_id() for h in planned.hints]
    assert len({g.to_felt() for g in gids}) == 2
    sht = SigHashToolbox(p.config, cfg, body, gids,
                         toolbox.block["transition"][0], device="cpu")
    orch.enqueue(planned)
    worker = Worker(toolbox, store, hub, sighash_toolbox=sht)
    processed = 0
    while worker.process_next_job():
        processed += 1
        assert processed < 300, "DAG did not converge"
    assert processed == planned.num_jobs
    note = hub.receive(Q_NOTIFICATIONS)
    assert note is not None
    assert JobID.from_bytes(note[1]).topic == \
        JobTopic.NOTIFY_ORCHESTRATOR_COMPLETE

    # the final-GL proofs bind (felt248 of the old city root, the sighash)
    for i, fin in enumerate(planned.sighash_final_jobs):
        proof = decode_proof(store.get_proof(fin.output_proof_id()))
        pis = [int(x) for x in proof.public_inputs]
        assert pis[0:4] == feltenc.hash256_to_felt248(old_bytes)
        assert pis[4:8] == feltenc.hash256_to_felt252(btc.sighash(
            planned.block_tx, i, cur_script, cfg.sighash_type))
        assert pis[4:8] == feltenc.hash256_to_felt252(jbtc.sighash(
            jplanned.block_tx, i, jplanned.covenant_script,
            cfg.sighash_type))
        assert verifier.verify(proof, sht.final_gl.data.common,
                               sht.final_gl.data.verifier)
    assert orch.finalize(planned, toolbox)

    # a final GL whose spend index is not the wrapper's gives no witness
    tr_proof = decode_proof(store.get_proof(
        planned.final_job.output_proof_id()))
    w0 = JobID(JobTopic.GENERATE_STANDARD_PROOF, 1,
               int(CircuitType.SIGHASH_WRAPPER), group_id=111, task_index=0)
    wrap_proof = decode_proof(store.get_proof(w0.output_proof_id()))
    with pytest.raises((ValueError, AssertionError)):
        sht.prove_final(tr_proof, wrap_proof,
                        {"cur_bal": prev_tx.outputs[0].value,
                         "next_bal": planned.block_tx.outputs[0].value,
                         "spend_idx": 1})


@pytest.mark.slow
def test_full_block_with_signatures():
    """Transfer and add_withdrawal ops recursively verify a real ZK
    signature wrapper proof binding (the sender's stored pk, the action
    hash); a proof signed under another key cannot pass the op circuit."""
    toolbox = CircuitToolbox(FAST_TEST_PARAMS, with_signatures=True,
                             device="cpu")
    p = toolbox.params
    city, store, hub = _city(CityStore, p), MemoryProofStore(), QueueHub()
    orch = om.Orchestrator(city, store, hub, params=p)
    wallet = CityMemoryWallet.new_fast_setup(wrapper=toolbox.zk_wrapper)
    pk0 = wallet.zk.create_zk_private_key()
    city.register_user(0, 0, pk0)
    city.register_user(0, 1, (2, 2, 2, 2))
    city.increment_user_balance(0, 0, 1_000 + 60 + p.withdrawal_fee)
    sig_t = wallet.zk.sign(pk0, om.transfer_action_hash(p, 0, 1, 1, 250))
    addr = (7, 8, 9)
    sig_w = wallet.zk.sign(pk0, om.withdrawal_action_hash(p, 0, 2, addr, 60))
    reqs = om.BlockRequests(
        token_transfers=[om.TokenTransfer(
            0, 1, 250, signature_proof=encode_proof(sig_t).hex())],
        add_withdrawals=[om.AddWithdrawal(
            0, 0, addr, 60, signature_proof=encode_proof(sig_w).hex())])
    planned = orch.plan_block(1, reqs)
    # the reference's plan of the same block: the same roots
    jcity = _city(JCityStore, JFAST)
    jcity.register_user(0, 0, pk0)
    jcity.register_user(0, 1, (2, 2, 2, 2))
    jcity.increment_user_balance(0, 0, 1_000 + 60 + JFAST.withdrawal_fee)
    jplanned = jom.Orchestrator(jcity, JStore(), JHub(),
                                params=JFAST).plan_block(1, _as_ref(reqs))
    assert (planned.start_city_root, planned.end_city_root) == \
        (jplanned.start_city_root, jplanned.end_city_root)
    orch.enqueue(planned)
    worker = Worker(toolbox, store, hub)
    processed = 0
    while worker.process_next_job():
        processed += 1
        assert processed < 100, "DAG did not converge"
    assert processed == planned.num_jobs
    assert orch.finalize(planned, toolbox)

    intruder = wallet.zk.create_zk_private_key()
    sig_bad = wallet.zk.sign(intruder, om.transfer_action_hash(p, 1, 1, 0, 10))
    planned2 = orch.plan_block(2, om.BlockRequests(token_transfers=[
        om.TokenTransfer(1, 0, 10,
                         signature_proof=encode_proof(sig_bad).hex())]))
    orch.enqueue(planned2)
    with pytest.raises((ValueError, AssertionError)):
        while worker.process_next_job():
            pass


@pytest.mark.slow
def test_claim_deposit_block_e2e():
    """A claim whose witness carries an L1 signature proof (the dev
    stand-in, L1DevSignatureCircuit), verified in-circuit by the op."""
    sk = 0xDEADBEEF1337
    pk = curve.ECDSAPublicKey(curve.scalar_mul(sk, curve.GENERATOR))
    pk9 = tuple(feltenc.bytes33_to_felts(pk.to_bytes_compressed()))
    dev = L1DevSignatureCircuit.build(FAST_TEST_PARAMS.config, device="cpu")
    params = dataclasses.replace(FAST_TEST_PARAMS, l1_sig_circuit=dev.data)
    toolbox = CircuitToolbox(params, device="cpu")
    city, store, hub = _city(CityStore, params), MemoryProofStore(), \
        QueueHub()
    orch = om.Orchestrator(city, store, hub, params=params)
    uid, dep_id, value = 5, 0, params.deposit_fee + 500
    txid224 = (11, 22, 33, 44)
    city.register_user(0, uid, (7, 7, 7, 7))
    city.add_deposit(0, dep_id, txid224, pk9, value)
    action = om.claim_action_hash(params, uid, txid224, value)
    msg_int = sum(int(a) << (64 * i) for i, a in enumerate(action))
    sig_proof = dev.prove(pk, msg_int)
    assert [int(x) for x in sig_proof.public_inputs] == \
        curve.combined_action_hash(pk, msg_int)
    reqs = om.BlockRequests(claim_deposits=[om.ClaimDeposit(
        uid, dep_id, txid224, pk9, value,
        l1_signature_proof=encode_proof(sig_proof).hex())])
    planned = orch.plan_block(1, reqs)
    jcity = _city(JCityStore, JFAST)
    jcity.register_user(0, uid, (7, 7, 7, 7))
    jcity.add_deposit(0, dep_id, txid224, pk9, value)
    jplanned = jom.Orchestrator(jcity, JStore(), JHub(),
                                params=JFAST).plan_block(1, _as_ref(reqs))
    assert (planned.start_city_root, planned.end_city_root) == \
        (jplanned.start_city_root, jplanned.end_city_root)
    orch.enqueue(planned)
    worker = Worker(toolbox, store, hub)
    n = 0
    while worker.process_next_job():
        n += 1
    assert n >= planned.num_jobs
    assert orch.finalize(planned, toolbox)
    bal, _, _ = city.get_user_state(uid, 1)
    assert bal == value - params.deposit_fee
