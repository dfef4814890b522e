"""The port's block planning (rollup/orchestrator.py over city_store,
proof_store, treeprover and the witness codec) against the reference's,
host only, at DEFAULT_PARAMS' tree heights (32).

Both packages' Orchestrators plan the CLI's demo block (checkpoint 1, after
cli.demo_genesis) and chip_smoke.block2_requests on top of it. Equal: the
start and end city roots (pinned as chip_smoke.GOLDEN_BLOCK_ROOTS, which
the card's run holds the proved blocks to), the job lists, the witness
bytes of every job and the counter DAG (the whole proof-store dump), and
the order in which the DAG releases the jobs."""

import dataclasses

import pytest

import chip_smoke
from city_rollup_tpu.rollup import orchestrator as jom
from city_rollup_tpu.rollup.city_store import CityStore as JCityStore
from city_rollup_tpu.rollup.job_id import JobID as JJobID
from city_rollup_tpu.rollup.proof_store import MemoryProofStore as JStore
from city_rollup_tpu.rollup.queues import QueueHub as JHub
from city_rollup_tpu_torch import cli
from city_rollup_tpu_torch.rollup import orchestrator as om
from city_rollup_tpu_torch.rollup.circuits import (DEFAULT_PARAMS,
                                                   decode_witness,
                                                   encode_witness)
from city_rollup_tpu_torch.rollup.city_store import CityStore
from city_rollup_tpu_torch.rollup.job_id import JobID, JobTopic
from city_rollup_tpu_torch.rollup.proof_store import MemoryProofStore
from city_rollup_tpu_torch.rollup.queues import Q_JOB, QueueHub


def _as_ref(requests):
    """The port's BlockRequests as the reference's (same fields)."""
    return jom.BlockRequests(**{
        f.name: [getattr(jom, type(r).__name__)(**vars(r))
                 for r in getattr(requests, f.name)]
        for f in dataclasses.fields(requests)})


def _plan(mod, city_cls, store_cls, hub_cls, requests_of):
    p = DEFAULT_PARAMS
    city = city_cls(user_tree_height=p.user_tree_height,
                    deposit_tree_height=p.deposit_tree_height,
                    withdrawal_tree_height=p.withdrawal_tree_height)
    cli.demo_genesis(city, p)
    store, hub = store_cls(), hub_cls()
    orch = mod.Orchestrator(city, store, hub, params=p)
    blocks = []
    for cp, req in enumerate(requests_of(), start=1):
        blocks.append(orch.plan_block(cp, req))
    return blocks, store, city


@pytest.fixture(scope="module")
def plans():
    port = _plan(om, CityStore, MemoryProofStore, QueueHub,
                 lambda: [cli.demo_requests(), chip_smoke.block2_requests(om)])
    ref = _plan(jom, JCityStore, JStore, JHub,
                lambda: [_as_ref(cli.demo_requests()),
                         chip_smoke.block2_requests(jom)])
    return port, ref


def test_demo_requests_are_the_reference_clis():
    """cli.demo_requests is the reference CLI's demo block."""
    got = _as_ref(cli.demo_requests())
    want = jom.BlockRequests(
        register_users=[jom.RegisterUser(2, (3, 3, 3, 3))],
        token_transfers=[jom.TokenTransfer(0, 1, v)
                         for v in (250, 100, 50)],
        add_withdrawals=[jom.AddWithdrawal(1, 0, (9, 9, 9), 25)])
    assert got == want


@pytest.mark.parametrize("block", [1, 2])
def test_city_roots_match_the_reference_and_the_golden(plans, block):
    (port, _, _), (ref, _, _) = plans
    p, r = port[block - 1], ref[block - 1]
    got = [list(p.start_city_root), list(p.end_city_root)]
    assert got == [list(r.start_city_root), list(r.end_city_root)]
    assert got == chip_smoke.GOLDEN_BLOCK_ROOTS[block - 1]
    if block == 2:
        assert p.start_city_root == port[0].end_city_root


@pytest.mark.parametrize("block", [1, 2])
def test_job_lists_match_the_reference(plans, block):
    (port, _, _), (ref, _, _) = plans
    p, r = port[block - 1], ref[block - 1]
    assert p.num_jobs == r.num_jobs == (15, 11)[block - 1]
    assert [j.to_bytes() for j in p.leaf_jobs] == \
        [j.to_bytes() for j in r.leaf_jobs]
    for name in ("final_job", "notify_job"):
        assert getattr(p, name).to_bytes() == getattr(r, name).to_bytes()
    assert p.withdrawal_events == r.withdrawal_events
    assert p.deposit_events == r.deposit_events


def test_witness_bytes_and_dag_match_the_reference(plans):
    """Every job's witness bytes, every counter (goal, next jobs) and every
    membership: the whole dump of both proof stores."""
    (_, pstore, _), (_, rstore, _) = plans
    pd, rd = pstore.dump(), rstore.dump()
    assert pd["data"] == rd["data"]
    assert pd["counters"] == rd["counters"]
    assert pd["membership"] == rd["membership"]
    assert len(pd["data"]) == 15 + 11         # one witness a job


def test_witness_codec_round_trips(plans):
    (_, pstore, _), _ = plans
    for raw in pstore.dump()["data"].values():
        w = decode_witness(bytes.fromhex(raw))
        assert encode_witness(w) == bytes.fromhex(raw)


def test_states_match_the_reference(plans):
    (_, _, pcity), (_, _, rcity) = plans
    for uid in range(4):
        for cp in (0, 1, 2):
            assert pcity.get_user_state(uid, cp) == \
                rcity.get_user_state(uid, cp)


@pytest.mark.parametrize("block", [1, 2])
def test_dag_releases_jobs_in_the_references_order(plans, block):
    """Drain each block's DAG without proving (a job done is released to
    its dependents), in both stores: the same jobs, in the same order,
    ending with the completion notification."""
    orders = []
    for blocks, store, mod_job in ((plans[0][0], plans[0][1], JobID),
                                   (plans[1][0], plans[1][1], JJobID)):
        store = type(store).restore(store.dump())
        planned = blocks[block - 1]
        queue = [j.to_bytes() for j in planned.leaf_jobs]
        order = []
        while queue:
            raw = queue.pop(0)
            order.append(raw)
            queue += [nj.to_bytes() for nj in
                      store.on_job_complete(mod_job.from_bytes(raw))]
        orders.append(order)
    assert orders[0] == orders[1]
    assert JobID.from_bytes(orders[0][-1]).topic == \
        JobTopic.NOTIFY_ORCHESTRATOR_COMPLETE
    assert len(orders[0]) == plans[0][0][block - 1].num_jobs + 1


def test_enqueue_dispatches_the_leaf_jobs(plans):
    (port, _, _), _ = plans
    hub = QueueHub()
    orch = om.Orchestrator(None, MemoryProofStore(), hub,
                           params=DEFAULT_PARAMS)
    orch.enqueue(port[0])
    got = []
    while (m := hub.receive(Q_JOB)) is not None:
        got.append(m[1])
    assert got == [j.to_bytes() for j in port[0].leaf_jobs]


def test_assemble_l1_transaction_waits_for_the_groth16_slice(plans):
    """Since the Groth16 slice the port assembles a block's L1 transaction
    (tests/test_torch_l1.py); a block planned without an L1 context, as the
    demo block is, has none to assemble, and is refused as the reference
    refuses it."""
    (port, _, _), _ = plans
    orch = om.Orchestrator(None, MemoryProofStore(), QueueHub(),
                           params=DEFAULT_PARAMS)
    with pytest.raises(AssertionError, match="without L1 ctx"):
        orch.assemble_l1_transaction(port[0])
