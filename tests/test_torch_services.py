"""The port's service layer (services/: rpc_common, api_server, node,
provider, user_prover, orchestrator_service) against the reference's:
the cases of tests/test_services.py on the port, the two packages' query
APIs answering the same questions over equal CityStores with the same
JSON, and the node's queues flushed into a block whose plan is the
reference's (the card's block 2 takes that path).

The user-prover service proves with whatever signer it is given: here the
port's inner ZK signature circuit (2^4 rows at the test configuration,
cheap on the CPU); the real wrapper (2^11 rows, tens of seconds of CPU a
proof) is the `slow` test's."""

import dataclasses
import time

import pytest
import torch

import chip_smoke
from city_rollup_tpu.rollup import orchestrator as jom
from city_rollup_tpu.rollup.city_store import CityStore as JCityStore
from city_rollup_tpu.rollup.proof_store import \
    MemoryProofStore as JMemoryProofStore
from city_rollup_tpu.rollup.queues import QueueHub as JQueueHub
from city_rollup_tpu.services.api_server import \
    make_api_server as jmake_api_server
from city_rollup_tpu_torch import cli
from city_rollup_tpu_torch.core.fri import FriConfig
from city_rollup_tpu_torch.rollup import orchestrator as om
from city_rollup_tpu_torch.rollup import zk_signature as zs
from city_rollup_tpu_torch.rollup.circuits import (DEFAULT_PARAMS,
                                                   decode_proof)
from city_rollup_tpu_torch.rollup.city_store import CityStore
from city_rollup_tpu_torch.rollup.job_id import CircuitType, JobID, JobTopic
from city_rollup_tpu_torch.rollup.proof_store import MemoryProofStore
from city_rollup_tpu_torch.rollup.queues import Q_CMD, Q_JOB, QueueHub
from city_rollup_tpu_torch.services.api_server import make_api_server
from city_rollup_tpu_torch.services.node import (PRODUCE_BLOCK_CMD,
                                                 flush_rpc_requests,
                                                 make_node_server)
from city_rollup_tpu_torch.services.orchestrator_service import (
    produce_one_block, wait_for_block_complete, wait_for_produce_block)
from city_rollup_tpu_torch.services.provider import CityRpcProvider
from city_rollup_tpu_torch.services.rpc_common import JsonRpcError, rpc_call
from city_rollup_tpu_torch.services.user_prover import \
    make_user_prover_server
from city_rollup_tpu_torch.snark import CircuitConfig, verifier
from test_torch_rollup_circuits import TEST_FRI


@pytest.fixture()
def stack():
    """node + api + provider over an in-memory hub/store/city."""
    city = CityStore()
    city.register_user(0, 0, (1, 1, 1, 1))
    city.increment_user_balance(0, 0, 500)
    store = MemoryProofStore()
    hub = QueueHub()
    api = make_api_server(city, store)
    api.start_background()
    node = make_node_server(hub, api_url=api.url,
                            fleet_verifies_signatures=True)
    node.start_background()
    yield {"city": city, "store": store, "hub": hub, "api": api,
           "node": node, "provider": CityRpcProvider(node_url=node.url)}
    node.shutdown()
    api.shutdown()


def test_query_api_roundtrips(stack):
    pr = stack["provider"]
    assert pr.ping() == "pong"
    root = pr.get_city_root(0)
    assert root == [int(x) for x in stack["city"].get_city_root(0)]
    user = pr.get_user_by_id(0, 0)
    assert user["balance"] == 500 and user["public_key"] == [1, 1, 1, 1]
    mp = pr.get_user_merkle_proof(0, 0)
    assert len(mp["siblings"]) == stack["city"].user_tree.height
    # reads forward through the node endpoint too
    assert rpc_call(stack["node"].url, "cr_getCityRoot", [0]) == root
    direct = CityRpcProvider(node_url=stack["node"].url,
                             api_url=stack["api"].url)
    assert direct.get_user_tree_root(0) == pr.get_user_tree_root(0)
    with pytest.raises(JsonRpcError):
        rpc_call(stack["api"].url, "cr_getLatestBlockState")   # none yet


def test_node_enqueues_and_flush_rebuilds_requests(stack):
    pr = stack["provider"]
    pr.register_user(5, (9, 9, 9, 9))
    pr.token_transfer(0, 5, 123)
    pr.add_withdrawal(0, 0, (1, 2, 3), 77, signature_proof="aa")
    pr.claim_deposit(0, 0, (1, 2, 3, 4), list(range(9)), 1000)
    reqs = flush_rpc_requests(stack["hub"])
    assert reqs.register_users == [om.RegisterUser(5, (9, 9, 9, 9))]
    assert reqs.token_transfers == [om.TokenTransfer(0, 5, 123)]
    assert reqs.add_withdrawals[0].signature_proof == "aa"
    assert reqs.claim_deposits[0].public_key == tuple(range(9))
    assert flush_rpc_requests(stack["hub"]).token_transfers == []


def test_node_without_sig_fleet_rejects_signature_proofs():
    """A node fronting a fleet without signature verification refuses
    signature-bearing requests and queues nothing for them."""
    hub = QueueHub()
    node = make_node_server(hub)          # fleet_verifies_signatures=False
    node.start_background()
    try:
        pr = CityRpcProvider(node_url=node.url)
        pr.token_transfer(0, 5, 123)      # unsigned: fine
        with pytest.raises(JsonRpcError) as e:
            pr.add_withdrawal(0, 0, (1, 2, 3), 77, signature_proof="aa")
        assert e.value.code == -32011
        with pytest.raises(JsonRpcError):
            pr.token_transfer(0, 5, 9, signature_proof="bb")
        with pytest.raises(JsonRpcError):
            pr.claim_deposit(0, 0, (1, 2, 3, 4), list(range(9)), 5,
                             l1_signature_proof="cc")
        reqs = flush_rpc_requests(hub)
        assert reqs.token_transfers == [om.TokenTransfer(0, 5, 123)]
        assert reqs.add_withdrawals == [] and reqs.claim_deposits == []
    finally:
        node.shutdown()


def test_node_validates_shapes(stack):
    pr = stack["provider"]
    with pytest.raises(JsonRpcError):
        pr.register_user(1, (1, 2, 3))            # pk must be 4 felts
    with pytest.raises(JsonRpcError):
        pr.add_withdrawal(0, 0, (1, 2, 3, 4), 5)  # address: 3 limbs
    with pytest.raises(JsonRpcError):
        pr.claim_deposit(0, 0, (1, 2, 3, 4), [1] * 8, 5)
    with pytest.raises(JsonRpcError) as e:
        rpc_call(stack["node"].url, "cr_noSuchMethodAnywhere")
    assert e.value.code == -32601
    with pytest.raises(JsonRpcError) as e:
        rpc_call(stack["api"].url, "cr_noSuchMethodAnywhere")
    assert e.value.code == -32601


def test_produce_block_command(stack):
    stack["provider"].produce_block()
    got = stack["hub"].receive(Q_CMD)
    assert got is not None and got[1] == PRODUCE_BLOCK_CMD


def test_proof_store_inspection(stack):
    j = JobID(JobTopic.GENERATE_STANDARD_PROOF, 1,
              int(CircuitType.OP_L2_TRANSFER))
    stack["store"].set_bytes(j.input_witness_id(), b'{"hello": 1}')
    stack["store"].set_bytes(j.output_proof_id(), b"\x01\x02")
    pr = stack["provider"]
    assert rpc_call(stack["api"].url, "cr_getProofStoreJobWitness",
                    [j.hex()]) == '{"hello": 1}'
    assert pr.get_proof_store_value(j.input_witness_id().hex()) == \
        b'{"hello": 1}'.hex()
    assert pr.get_proof_store_value(j.output_proof_id().hex()) == "0102"
    unset = JobID(JobTopic.GENERATE_STANDARD_PROOF, 1,
                  int(CircuitType.OP_L2_TRANSFER), task_index=5)
    assert rpc_call(stack["api"].url, "cr_getProofStoreValues",
                    [[j.output_proof_id().hex(), unset.hex()]]) == \
        ["0102", None]


def test_orchestrator_service_plumbing():
    """wait_for_produce_block + flush + plan (no proving): the sync loop's
    step 1; then this block's completion notification ends
    wait_for_block_complete, and another block's is put back."""
    city = CityStore()
    city.register_user(0, 0, (1, 1, 1, 1))
    city.increment_user_balance(0, 0, 500)
    store = MemoryProofStore()
    hub = QueueHub()
    orch = om.Orchestrator(city, store, hub)
    node = make_node_server(hub)
    node.start_background()
    try:
        pr = CityRpcProvider(node_url=node.url)
        assert not wait_for_produce_block(hub, poll_s=0.01, timeout_s=0.05)
        pr.token_transfer(0, 0, 0)          # self-transfer of 0 still plans
        pr.produce_block()
        assert wait_for_produce_block(hub, timeout_s=5)
        planned, done = produce_one_block(orch, hub, 1)
        assert done is None                  # not awaited
        assert planned.num_jobs > 0 and len(planned.leaf_jobs) >= 1
        assert not wait_for_block_complete(hub, planned, poll_s=0.01,
                                           timeout_s=0.05)
        other = dataclasses.replace(planned.notify_job, goal_id=7)
        hub.dispatch("q_notifications", other.to_bytes())
        hub.dispatch("q_notifications", planned.notify_job.to_bytes())
        assert wait_for_block_complete(hub, planned, poll_s=0.01,
                                       timeout_s=5)
        got = hub.receive("q_notifications")
        assert got is not None and got[1] == other.to_bytes()
    finally:
        node.shutdown()


def test_produce_one_block_awaits_completion_and_records_state():
    """With a timeout, produce_one_block awaits the block's completion
    notification and records its block state."""
    city = CityStore()
    city.register_user(0, 0, (1, 1, 1, 1))
    city.increment_user_balance(0, 0, 500)
    hub = QueueHub()
    orch = om.Orchestrator(city, MemoryProofStore(), hub)
    # the completion notification is already there: nothing proves here
    planned = orch.plan_block(1, om.BlockRequests(
        token_transfers=[om.TokenTransfer(0, 0, 0)]))
    hub.dispatch("q_notifications", planned.notify_job.to_bytes())
    again, done = produce_one_block(
        orch, hub, 1, extra_requests=om.BlockRequests(
            token_transfers=[om.TokenTransfer(0, 0, 0)]), timeout_s=5)
    assert done is True
    assert again.notify_job.to_bytes() == planned.notify_job.to_bytes()
    st = city.get_block_state(1)
    assert st.checkpoint_id == 1


def equal_cities():
    """A port and a reference CityStore with the same history: genesis and
    the CLI's demo block planned at DEFAULT_PARAMS' tree heights."""
    out = []
    for mod, city_cls, store_cls, hub_cls in [
            (om, CityStore, MemoryProofStore, QueueHub),
            (jom, JCityStore, JMemoryProofStore, JQueueHub)]:
        p = DEFAULT_PARAMS
        city = city_cls(user_tree_height=p.user_tree_height,
                        deposit_tree_height=p.deposit_tree_height,
                        withdrawal_tree_height=p.withdrawal_tree_height)
        cli.demo_genesis(city, p)
        store = store_cls()
        orch = mod.Orchestrator(city, store, hub_cls(), params=p)
        reqs = cli.demo_requests()
        if mod is jom:
            reqs = as_ref(reqs)
        planned = orch.plan_block(1, reqs)
        out.append((city, store, planned))
    return out


def as_ref(requests):
    """The port's BlockRequests as the reference's (same fields)."""
    return jom.BlockRequests(**{
        f.name: [getattr(jom, type(r).__name__)(**vars(r))
                 for r in getattr(requests, f.name)]
        for f in dataclasses.fields(requests)})


def answer(url, method, params):
    """("ok", result) or ("error", code, message) of one call."""
    try:
        return ("ok", rpc_call(url, method, params))
    except JsonRpcError as e:
        return ("error", e.code, str(e))


def test_api_servers_answer_alike():
    """The port's and the reference's query APIs over equal CityStores and
    proof stores give the same JSON to every query."""
    (city, store, planned), (jcity, jstore, _) = equal_cities()
    api, japi = make_api_server(city, store), jmake_api_server(jcity, jstore)
    api.start_background()
    japi.start_background()
    job = planned.leaf_jobs[0].hex()
    queries = [("cr_ping", []), ("cr_getCityRoot", [0]),
               ("cr_getCityRoot", [1]), ("cr_getUserTreeRoot", [1]),
               ("cr_getDepositTreeRoot", [1]),
               ("cr_getWithdrawalTreeRoot", [1]),
               ("cr_getUserById", [1, 1]), ("cr_getUserById", [2, 1]),
               ("cr_getUserMerkleProofById", [0, 1]),
               ("cr_getWithdrawalLeaf", [0, 1]),
               ("cr_getWithdrawalMerkleProof", [0, 1]),
               ("cr_getDepositLeaf", [0, 1]),
               ("cr_getDepositMerkleProof", [0, 0]),
               ("cr_getBlockState", [1]), ("cr_getLatestBlockState", []),
               ("cr_getProofStoreJobWitness", [job]),
               ("cr_getProofStoreJobWitnesses", [[job, job]]),
               ("cr_getProofStoreValue", [job])]
    try:
        for method, params in queries:
            got = [answer(srv.url, method, params) for srv in (api, japi)]
            assert got[0] == got[1], method
        assert answer(api.url, "cr_getLatestBlockState", [])[0] == "error"
        assert rpc_call(api.url, "cr_getCityRoot", [1]) == \
            chip_smoke.GOLDEN_BLOCK_ROOTS[0][1]
    finally:
        api.shutdown()
        japi.shutdown()


def test_flushed_block_plans_as_the_references():
    """Block 2 of the card's run (chip_smoke.block2_requests) sent through
    the port's node and flushed into a block, on top of the demo block:
    the reference's roots (GOLDEN_BLOCK_ROOTS) and jobs."""
    (city, store, _), (jcity, jstore, _) = equal_cities()
    hub = QueueHub()
    node = make_node_server(hub)
    node.start_background()
    try:
        pr = CityRpcProvider(node_url=node.url)
        want = chip_smoke.block2_requests(om)
        for r in want.register_users:
            pr.register_user(r.user_id, r.public_key)
        for t in want.token_transfers:
            pr.token_transfer(t.from_user, t.to_user, t.value)
        pr.produce_block()
        assert wait_for_produce_block(hub, timeout_s=5)
        orch = om.Orchestrator(city, store, hub, params=DEFAULT_PARAMS)
        planned, _ = produce_one_block(orch, hub, 2)
    finally:
        node.shutdown()
    jorch = jom.Orchestrator(jcity, jstore, JQueueHub(),
                             params=DEFAULT_PARAMS)
    jplanned = jorch.plan_block(2, as_ref(want))
    roots = [list(planned.start_city_root), list(planned.end_city_root)]
    assert roots == chip_smoke.GOLDEN_BLOCK_ROOTS[1]
    assert roots == [list(jplanned.start_city_root),
                     list(jplanned.end_city_root)]
    assert [j.hex() for j in planned.leaf_jobs] == \
        [j.hex() for j in jplanned.leaf_jobs]
    assert planned.num_jobs == jplanned.num_jobs
    queued = []
    while (got := hub.receive(Q_JOB)) is not None:
        queued.append(got[1])
    assert queued == [j.to_bytes() for j in planned.leaf_jobs]


def await_proof(url, jid, seconds):
    deadline = time.monotonic() + seconds
    while True:
        st = rpc_call(url, "cr_getProof", [jid])
        if st["status"] != "pending":
            return st
        assert time.monotonic() < deadline, "prover timed out"
        time.sleep(0.1)


def test_user_prover_service_proves_and_dedupes():
    """The service over the port's inner ZK signature circuit on the CPU:
    the public key, a proof of pk || action that verifies, the same job id
    for the same request, and an error status for an L1 signature the
    service was built without."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cfg = CircuitConfig.poseidon_config(num_challenges=1,
                                            fri=FriConfig(**TEST_FRI))
        signer = zs.ZKSignatureInnerCircuit.build(cfg, device="cpu")
        srv = make_user_prover_server(signer)
        srv.start_background()
        try:
            sk, action = [11, 22, 33, 44], [5, 6, 7, 8]
            pk = rpc_call(srv.url, "cr_getZkPublicKey", [sk])
            assert pk == zs.derive_public_key(sk)
            with pytest.raises(JsonRpcError):
                rpc_call(srv.url, "cr_getZkPublicKey", [[1, 2, 3]])
            jid = rpc_call(srv.url, "cr_proveZkSignature", [sk, action])
            st = await_proof(srv.url, jid, 300)
            assert st["status"] == "done", st
            proof = decode_proof(bytes.fromhex(st["proof"]))
            assert list(proof.public_inputs) == pk + action
            assert verifier.verify(proof, signer.data.common,
                                   signer.data.verifier)
            assert rpc_call(srv.url, "cr_proveZkSignature",
                            [sk, action]) == jid
            assert rpc_call(srv.url, "cr_getProof", ["feed"]) == \
                {"status": "unknown"}
            # secp256k1's generator as the public key
            g = "0279BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798"
            ljid = rpc_call(srv.url, "cr_proveSecp256k1Signature",
                            [g, "01", "01" * 64])
            st = await_proof(srv.url, ljid, 60)
            assert st["status"] == "error" and "L1 signature" in st["error"]
        finally:
            srv.shutdown()
    finally:
        torch.set_num_threads(threads)


@pytest.mark.slow
def test_user_prover_service_end_to_end():
    """The service over the real ZK signature wrapper at FAST_TEST_CONFIG
    (tests/test_services.py's case, on the port's CPU path)."""
    from city_rollup_tpu_torch.rollup.circuits import FAST_TEST_CONFIG
    wrapper = zs.ZKSignatureWrapperCircuit.build(FAST_TEST_CONFIG,
                                                 device="cpu")
    srv = make_user_prover_server(wrapper)
    srv.start_background()
    try:
        sk, action = [11, 22, 33, 44], [5, 6, 7, 8]
        pk = rpc_call(srv.url, "cr_getZkPublicKey", [sk])
        jid = rpc_call(srv.url, "cr_proveZkSignature", [sk, action])
        st = await_proof(srv.url, jid, 3600)
        assert st["status"] == "done", st
        proof = decode_proof(bytes.fromhex(st["proof"]))
        assert list(proof.public_inputs) == pk + action
        assert wrapper.verify(proof)
        assert rpc_call(srv.url, "cr_proveZkSignature", [sk, action]) == jid
    finally:
        srv.shutdown()
