"""The port's L1 link and block-transaction assembly (rollup/link.py,
Orchestrator.assemble_l1_transaction) against the reference's: the cases
of tests/test_l1_link.py on the port, and a block planned with a Groth16
wrap in both packages from the same requests and wrap outputs, whose
assembled transactions serialize to the same bytes."""

import json
import random

import pytest

from city_rollup_tpu.crypto.qhashout import QHashOut as JQHashOut
from city_rollup_tpu.rollup import btc as jbtc
from city_rollup_tpu.rollup import groth16_wrap as jg16w
from city_rollup_tpu.rollup import orchestrator as jom
from city_rollup_tpu.rollup.circuits import \
    FAST_TEST_PARAMS as J_FAST_TEST_PARAMS
from city_rollup_tpu.rollup.city_store import CityStore as JCityStore
from city_rollup_tpu.rollup.link import MemoryBTCLink as JMemoryBTCLink
from city_rollup_tpu.rollup.proof_store import \
    MemoryProofStore as JMemoryProofStore
from city_rollup_tpu.rollup.queues import QueueHub as JQueueHub
from city_rollup_tpu_torch.crypto import groth16 as g16
from city_rollup_tpu_torch.crypto.qhashout import QHashOut
from city_rollup_tpu_torch.rollup import btc
from city_rollup_tpu_torch.rollup import groth16_wrap as g16w
from city_rollup_tpu_torch.rollup import orchestrator as om
from city_rollup_tpu_torch.rollup.circuits import FAST_TEST_PARAMS
from city_rollup_tpu_torch.rollup.city_store import CityStore
from city_rollup_tpu_torch.rollup.link import MemoryBTCLink
from city_rollup_tpu_torch.rollup.proof_store import MemoryProofStore
from city_rollup_tpu_torch.rollup.queues import QueueHub

rnd = random.Random(5)


def spend_cfg(mod):
    """tests/test_l1_link.py's covenant configuration."""
    return mod.BlockSpendCoreConfig(
        block_spend_index=0, block_funding_script_size=20,
        block_sighash_script_size=41, block_output_script_size=23,
        deposit_funding_script_size=40, withdrawal_output_script_size=25,
        sighash_type=1, locktime=0, version=2)


TEST_BODY = bytes(range(8))
FABRICATED = {"pi_a": "aa" * 48, "pi_b_a0": "bb" * 48, "pi_b_a1": "cc" * 48,
              "pi_c": "dd" * 48}


def toy_proof_data() -> dict:
    """CityGroth16ProofData of a real (toy-statement) Groth16 proof."""
    r1cs = g16.R1CS(num_public=1, num_vars=4, a_rows=[{2: 1}],
                    b_rows=[{3: 1}], c_rows=[{1: 1}])
    pk, _ = g16.setup(r1cs, b"l1", dev_deterministic=True)
    return g16.prove(pk, [1, 6, 2, 3], rand_seed=b"r").to_city_data()


def test_memory_link_utxo_tracking():
    link = MemoryBTCLink()
    addr = bytes(rnd.randrange(256) for _ in range(20))
    tx = link.fund_address(addr, 1_000)
    assert link.get_transaction(tx.txid()).serialize() == tx.serialize()
    found = link.get_confirmed_funding_transactions(addr)
    assert [t.txid() for t in found] == [tx.txid()]
    spend = btc.BTCTransaction(
        version=2,
        inputs=[btc.BTCTransactionInput(hash=tx.txid(), index=0,
                                        script=b"")],
        outputs=[btc.BTCTransactionOutput(
            value=900, script=btc.p2sh_script(addr))],
        locktime=0)
    link.send_transaction(spend)
    assert link.get_confirmed_funding_transactions(addr) == []   # unmined
    link.mine_blocks(1)
    found = link.get_confirmed_funding_transactions(addr)
    assert [t.txid() for t in found] == [spend.txid()]
    with pytest.raises(AssertionError, match="double spend"):
        link.send_transaction(spend)
    # the reference's link holds the same transaction under the same txid
    jtx = jbtc.BTCTransaction.parse(tx.serialize())
    assert JMemoryBTCLink().send_transaction(jtx) == tx.txid()


def test_push_data_encodings():
    assert btc.push_data(b"ab") == b"\x02ab" == jbtc.push_data(b"ab")
    for n in (75, 76, 80, 255, 256, 300):
        assert btc.push_data(bytes(n)) == jbtc.push_data(bytes(n))
    assert btc.push_data(bytes(80))[:2] == bytes([btc.OP_PUSHDATA1, 80])
    ws = btc.encode_binary_witness_script_for_p2sh(b"SCRIPT", [b"a", b"b"])
    assert ws == b"\x01a\x01b\x06SCRIPT"


def plan_with_groth16(om_mod, city_cls, store_cls, hub_cls, qhash_cls,
                      btc_mod, params):
    """(orchestrator, store, planned) of tests/test_l1_link.py's block in
    one package: genesis user 0, an empty block 1 with an L1 context that
    asks for the Groth16 wrap."""
    city = city_cls(user_tree_height=8, deposit_tree_height=8,
                    withdrawal_tree_height=8)
    store, hub = store_cls(), hub_cls()
    orch = om_mod.Orchestrator(city, store, hub, params=params)
    city.register_user(0, 0, (1, 1, 1, 1))
    old_bytes = qhash_cls(tuple(city.get_city_root(0))).to_le_bytes()
    prev_tx = om_mod.make_genesis_block_tx(spend_cfg(btc_mod), TEST_BODY,
                                           old_bytes, balance=5_000_000)
    ctx = om_mod.L1BlockContext(
        spend_cfg=spend_cfg(btc_mod), script_body=TEST_BODY,
        prev_block_tx=prev_tx, deposit_txs=[], with_groth16=True)
    planned = orch.plan_block(1, om_mod.BlockRequests(), l1_context=ctx)
    return orch, store, planned


@pytest.mark.parametrize("source", ["fabricated", "toy proof"])
def test_assemble_l1_transaction_equals_the_references(source):
    """Both packages plan the block alike, refuse to broadcast without a
    dev-mode flag, and with GROTH16_WRAP_ATTESTATION_DEV_MODE fill the
    input scripts with the wrap's pushes and the covenant script: the same
    transaction bytes, broadcast on the link."""
    pd = FABRICATED if source == "fabricated" else toy_proof_data()
    orch, store, planned = plan_with_groth16(
        om, CityStore, MemoryProofStore, QueueHub, QHashOut, btc,
        FAST_TEST_PARAMS)
    jorch, jstore, jplanned = plan_with_groth16(
        jom, JCityStore, JMemoryProofStore, JQueueHub, JQHashOut, jbtc,
        J_FAST_TEST_PARAMS)
    assert len(planned.groth16_jobs) == 1
    assert [j.hex() for j in planned.groth16_jobs] == \
        [j.hex() for j in jplanned.groth16_jobs]
    assert planned.block_tx.serialize() == jplanned.block_tx.serialize()
    assert planned.covenant_script == jplanned.covenant_script
    assert planned.num_jobs == jplanned.num_jobs
    # the wrap output, as the worker writes it
    raw = json.dumps({"proof_data": pd, "public_inputs": []}).encode()
    store.set_bytes(planned.groth16_jobs[0].output_proof_id(), raw)
    jstore.set_bytes(jplanned.groth16_jobs[0].output_proof_id(), raw)
    link, jlink = MemoryBTCLink(), JMemoryBTCLink()
    with pytest.raises(RuntimeError, match="refusing to broadcast"):
        orch.assemble_l1_transaction(planned, b"VDATA", link=link)
    with pytest.raises(RuntimeError, match="refusing to broadcast"):
        jorch.assemble_l1_transaction(jplanned, b"VDATA", link=jlink)
    # without a link nothing is broadcast, and nothing is refused
    unsent = orch.assemble_l1_transaction(planned, b"VDATA")
    g16w.GROTH16_WRAP_ATTESTATION_DEV_MODE = True
    jg16w.GROTH16_WRAP_ATTESTATION_DEV_MODE = True
    try:
        final_tx = orch.assemble_l1_transaction(planned, b"VDATA",
                                                link=link)
        jfinal_tx = jorch.assemble_l1_transaction(jplanned, b"VDATA",
                                                  link=jlink)
    finally:
        g16w.GROTH16_WRAP_ATTESTATION_DEV_MODE = False
        jg16w.GROTH16_WRAP_ATTESTATION_DEV_MODE = False
    assert final_tx.serialize() == jfinal_tx.serialize() == \
        unsent.serialize()
    script = final_tx.inputs[0].script
    assert script[0] == 48 and script[1:49] == bytes.fromhex(pd["pi_a"])
    assert script.endswith(btc.push_data(planned.covenant_script))
    assert link.get_transaction(final_tx.txid()) is final_tx
    assert btc.BTCTransaction.parse(final_tx.serialize()).txid() == \
        final_tx.txid()


def test_disabled_groth16_mode_also_allows_the_broadcast():
    orch, store, planned = plan_with_groth16(
        om, CityStore, MemoryProofStore, QueueHub, QHashOut, btc,
        FAST_TEST_PARAMS)
    store.set_bytes(planned.groth16_jobs[0].output_proof_id(),
                    json.dumps({"proof_data": FABRICATED}).encode())
    link = MemoryBTCLink()
    g16w.GROTH16_DISABLED_DEV_MODE = True
    try:
        tx = orch.assemble_l1_transaction(planned, link=link)
    finally:
        g16w.GROTH16_DISABLED_DEV_MODE = False
    assert link.get_transaction(tx.txid()) is tx


def deposit_tx(mod, covenant_script: bytes, value: int, rnd):
    """tests/test_full_block_sighash.py's deposit to the covenant."""
    pk = b"\x02" + bytes(rnd.randrange(256) for _ in range(32))
    return mod.BTCTransaction(
        version=2,
        inputs=[mod.BTCTransactionInput(
            hash=bytes(rnd.randrange(256) for _ in range(32)), index=0,
            script=bytes(7) + pk)],
        outputs=[mod.BTCTransactionOutput(
            value=value,
            script=mod.p2sh_script(mod.p2sh_address_of(covenant_script)))],
        locktime=0)


def fake_drain(om_mod, city_cls, store_cls, hub_cls, qhash_cls, btc_mod,
               worker_cls, jid_cls, params, deposits: int,
               with_groth16: bool):
    """Plan an L1 block of 1 + `deposits` inputs and run its DAG with
    every job completed at once (no proving): (jobs run, jobs planned,
    the jobs run before the completion notification, the store's
    dump)."""
    rnd = random.Random(9)
    city = city_cls(user_tree_height=8, deposit_tree_height=8,
                    withdrawal_tree_height=8)
    store, hub = store_cls(), hub_cls()
    orch = om_mod.Orchestrator(city, store, hub, params=params)
    city.register_user(0, 0, (1, 1, 1, 1))
    old_bytes = qhash_cls(tuple(city.get_city_root(0))).to_le_bytes()
    cov = bytes([btc_mod.OP_PUSHBYTES_32]) + old_bytes + TEST_BODY
    prev_tx = om_mod.make_genesis_block_tx(spend_cfg(btc_mod), TEST_BODY,
                                           old_bytes, balance=5_000_000)
    deps = [deposit_tx(btc_mod, cov, 1_000_000, rnd)
            for _ in range(deposits)]
    reqs = om_mod.BlockRequests(
        add_deposits=om_mod.requests_from_deposit_txs(deps, 0))
    ctx = om_mod.L1BlockContext(
        spend_cfg=spend_cfg(btc_mod), script_body=TEST_BODY,
        prev_block_tx=prev_tx, deposit_txs=deps, with_groth16=with_groth16)
    planned = orch.plan_block(1, reqs, l1_context=ctx)
    orch.enqueue(planned)
    worker = worker_cls(None, store, hub)
    ran = []
    before_note = None
    while (got := hub.receive("q_job")) is not None:
        mid, msg = got
        job = jid_cls.from_bytes(msg)
        store.set_bytes(job.output_proof_id(), b"proof")
        worker._release(job)
        hub.ack("q_job", mid)
        ran.append(job.hex())
        if before_note is None and len(hub.queue("q_notifications")):
            before_note = list(ran)
    return ran, planned, before_note, store.dump()


@pytest.mark.parametrize("deposits,with_groth16",
                         [(0, False), (0, True), (1, False), (1, True)])
def test_l1_block_dag_runs_every_job(deposits, with_groth16):
    """The port's plan of an L1 block runs every job, the sighash chain of
    each input and its Groth16 wrap before the completion notification.
    The reference's DAG puts every input's edges on input 0's counters and
    the Groth16 edge on the final GL's join counter (ROADMAP, reference
    caveats): with more than one input, or with the wrap, some jobs never
    run and the notification never comes. With one input and no wrap the
    two plans are the same, counters and all."""
    from city_rollup_tpu.rollup.job_id import JobID as JJobID
    from city_rollup_tpu.rollup.worker import Worker as JWorker
    from city_rollup_tpu_torch.rollup.job_id import JobID
    from city_rollup_tpu_torch.rollup.worker import Worker
    ran, planned, before_note, dump = fake_drain(
        om, CityStore, MemoryProofStore, QueueHub, QHashOut, btc, Worker,
        JobID, FAST_TEST_PARAMS, deposits, with_groth16)
    assert sorted(ran) == sorted(set(ran)) and len(ran) == planned.num_jobs
    assert before_note is not None and len(before_note) == len(ran)
    assert len(planned.hints) == 1 + deposits
    assert len(planned.groth16_jobs) == (1 + deposits) * with_groth16
    jran, jplanned, _, jdump = fake_drain(
        jom, JCityStore, JMemoryProofStore, JQueueHub, JQHashOut, jbtc,
        JWorker, JJobID, J_FAST_TEST_PARAMS, deposits, with_groth16)
    assert jplanned.num_jobs == planned.num_jobs
    assert jplanned.block_tx.serialize() == planned.block_tx.serialize()
    if deposits or with_groth16:
        assert len(jran) < jplanned.num_jobs
    else:
        assert jran == ran
        for d in (dump, jdump):
            d["counted"] = sorted(map(tuple, d["counted"]))
        assert jdump == dump
