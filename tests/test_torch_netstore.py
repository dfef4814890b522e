"""The port's networked proof store and queues (rollup/netstore.py) against
the reference's: the cases of tests/test_netstore.py run on the port's
server and clients, and across the wire (the port's clients on the
reference's server, the reference's clients on the port's), since the
wire protocol is the contract between the fleet's processes; and a block
planned by the port's orchestrator through the port's netstore holds what
the reference's plan holds in its MemoryProofStore."""

import os
import subprocess
import sys
import threading
import time

import pytest

from city_rollup_tpu.rollup import netstore as jnet
from city_rollup_tpu.rollup import orchestrator as jom
from city_rollup_tpu.rollup.circuits import \
    FAST_TEST_PARAMS as J_FAST_TEST_PARAMS
from city_rollup_tpu.rollup.city_store import CityStore as JCityStore
from city_rollup_tpu.rollup.job_id import JobID as JJobID
from city_rollup_tpu.rollup.proof_store import \
    MemoryProofStore as JMemoryProofStore
from city_rollup_tpu.rollup.queues import QueueHub as JQueueHub
from city_rollup_tpu_torch.rollup import netstore as net
from city_rollup_tpu_torch.rollup import orchestrator as om
from city_rollup_tpu_torch.rollup.circuits import FAST_TEST_PARAMS
from city_rollup_tpu_torch.rollup.city_store import CityStore
from city_rollup_tpu_torch.rollup.job_id import CircuitType, JobID, JobTopic
from city_rollup_tpu_torch.rollup.queues import Q_JOB

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (server package, client package): the port alone, then across the wire
WIRES = [(net, net), (jnet, net), (net, jnet)]
WIRE_IDS = ["port-port", "reference-server", "reference-clients"]


def J(i):
    return JobID(JobTopic.GENERATE_STANDARD_PROOF, 1,
                 int(CircuitType.OP_L2_TRANSFER), task_index=i)


def as_client_jid(client, jid):
    """A job id of the client's package (the clients take their own
    JobID)."""
    return jid if client is net else JJobID.from_bytes(jid.to_bytes())


@pytest.fixture(params=WIRES, ids=WIRE_IDS)
def wire(request):
    """(server, client module, J of the client's package), the server
    started with a 1 s visibility timeout."""
    server_mod, client = request.param
    srv = server_mod.StoreServer(visibility_timeout_s=1.0)
    srv.start_background()
    yield srv, client, (lambda i: as_client_jid(client, J(i)))
    srv.shutdown()


def test_netstore_kv_idempotent(wire):
    srv, client, jid = wire
    s = client.NetProofStore(srv.host, srv.port)
    assert s.get_bytes(jid(0)) is None
    s.set_bytes(jid(0), b"first")
    s.set_bytes(jid(0), b"second")            # hset_nx: first write wins
    assert s.get_bytes(jid(0)) == b"first"
    assert s.get_proof(jid(0)) == b"first"


def test_netstore_counter_dag(wire):
    srv, client, jid = wire
    s = client.NetProofStore(srv.host, srv.port)
    jobs = [jid(1), jid(2)]
    s.write_next_jobs(jobs, [jid(9)])
    assert s.get_goal(jobs[0].counter_id()) == 2
    assert [j.hex() for j in s.memberships(jobs[0])] == \
        [jobs[0].counter_id().hex()]
    assert s.on_job_complete(jobs[0]) == []
    assert [j.hex() for j in s.on_job_complete(jobs[1])] == [jid(9).hex()]


def test_counter_exactly_once_per_job(wire):
    """A replayed increment for the same (counter, job) pair must not count
    twice (it could release a parent early or overshoot the goal)."""
    srv, client, jid = wire
    s = client.NetProofStore(srv.host, srv.port)
    jobs = [jid(1), jid(2)]
    s.write_next_jobs(jobs, [jid(9)])
    assert s.on_job_complete(jobs[0]) == []
    assert s.on_job_complete(jobs[0]) == []
    assert s.inc_counter(jobs[0].counter_id(), jobs[0]) == -1
    assert [j.hex() for j in s.on_job_complete(jobs[1])] == [jid(9).hex()]
    assert s.on_job_complete(jobs[1]) == []


def test_netstore_counter_atomic_across_clients(wire):
    """Concurrent increments from many connections count once each."""
    srv, client, jid = wire
    client.NetProofStore(srv.host, srv.port).write_next_jobs(
        [jid(i) for i in range(32)], [jid(99)])
    counter = jid(0).counter_id()
    results = []

    def bump():
        results.append(client.NetProofStore(srv.host, srv.port)
                       .inc_counter(counter))

    threads = [threading.Thread(target=bump) for _ in range(32)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert sorted(results) == list(range(1, 33))


def test_netqueue_visibility_redelivery(wire):
    """A popped, unacked message reappears after the visibility window;
    an acked one is gone; sends are FIFO."""
    srv, client, _ = wire
    hub = client.NetQueueHub(srv.host, srv.port)
    hub.dispatch("q_job", b"payload")
    got = hub.receive("q_job")
    assert got is not None and got[1] == b"payload"
    assert hub.receive("q_job") is None          # hidden while in flight
    time.sleep(1.2)
    again = hub.receive("q_job")
    assert again is not None and again[1] == b"payload"
    assert hub.ack("q_job", again[0])
    assert not hub.ack("q_job", again[0])
    time.sleep(1.2)
    assert hub.receive("q_job") is None          # acked: gone for good
    for msg in (b"first", b"second"):
        hub.dispatch("fifo", msg)
    got = [hub.receive("fifo"), hub.receive("fifo")]
    assert [m for _, m in got] == [b"first", b"second"]
    assert all(hub.ack("fifo", mid) for mid, _ in got)


def test_send_is_deduplicated_by_client_id(wire):
    """A retried send (same client id) enqueues once: the server answers
    it with the first send's message id."""
    srv, client, _ = wire
    conn = client._Conn(srv.host, srv.port)
    first = conn.call({"op": "send", "topic": "t", "msg": "aa", "cid": "x"})
    again = conn.call({"op": "send", "topic": "t", "msg": "aa", "cid": "x"})
    assert first == again
    hub = client.NetQueueHub(srv.host, srv.port)
    assert hub.receive("t")[1] == b"\xaa"
    assert hub.receive("t") is None
    assert conn.call({"op": "ping"}) == {"ok": True}
    with pytest.raises(RuntimeError, match="netstore"):
        conn.call({"op": "no-such-op"})


def test_client_reconnects_after_the_server_drops_it(wire):
    """_Conn reconnects once when its socket is gone."""
    srv, client, jid = wire
    s = client.NetProofStore(srv.host, srv.port)
    s.set_bytes(jid(3), b"v")
    s._c._sock.close()
    assert s.get_bytes(jid(3)) == b"v"


def plan_block(om_mod, city_cls, params, store, hub):
    """The two-worker test's block (tests/test_netstore.py) planned and
    enqueued in one package's orchestrator over `store` and `hub`."""
    city = city_cls(user_tree_height=params.user_tree_height,
                    deposit_tree_height=params.deposit_tree_height,
                    withdrawal_tree_height=params.withdrawal_tree_height)
    orch = om_mod.Orchestrator(city, store, hub, params=params)
    city.register_user(0, 0, (1, 1, 1, 1))
    city.register_user(0, 1, (2, 2, 2, 2))
    city.increment_user_balance(0, 0, 1000)
    reqs = om_mod.BlockRequests(
        register_users=[om_mod.RegisterUser(2, (3, 3, 3, 3))],
        token_transfers=[om_mod.TokenTransfer(0, 1, 250),
                         om_mod.TokenTransfer(0, 1, 100)])
    planned = orch.plan_block(1, reqs)
    orch.enqueue(planned)
    return orch, planned


def canonical(dump: dict) -> dict:
    return dict(dump, counted=sorted(map(tuple, dump["counted"])))


def test_plan_through_the_netstore_equals_the_references_memory_plan():
    """The port's orchestrator planning through the port's netstore leaves
    the server the data, counters and memberships of the reference's plan
    in a MemoryProofStore, and the same jobs on the queue."""
    srv = net.StoreServer()
    srv.start_background()
    try:
        store = net.NetProofStore(srv.host, srv.port)
        hub = net.NetQueueHub(srv.host, srv.port)
        _, planned = plan_block(om, CityStore, FAST_TEST_PARAMS, store, hub)
        jstore, jhub = JMemoryProofStore(), JQueueHub()
        _, jplanned = plan_block(jom, JCityStore, J_FAST_TEST_PARAMS, jstore,
                                 jhub)
        dump = store._c.call({"op": "dump"})["dump"]
        assert canonical(dump) == canonical(jstore.dump())
        assert planned.num_jobs == jplanned.num_jobs
        queued, jqueued = [], []
        while (got := hub.receive(Q_JOB)) is not None:
            queued.append(got[1])
        while (got := jhub.receive(Q_JOB)) is not None:
            jqueued.append(got[1])
        assert queued == jqueued == [j.to_bytes()
                                     for j in planned.leaf_jobs]
    finally:
        srv.shutdown()


@pytest.mark.slow
def test_two_worker_processes_drain_one_block():
    """The fleet on the CPU: the port's orchestrator plans a block against
    the port's netstore, two `cli l2-worker --device cpu` processes drain
    it, one is killed once it has proved a job (its in-flight job is
    redelivered after the visibility window), counters release exactly
    once, the block finalizes (tests/test_netstore.py's drain, on the
    port; hours of CPU)."""
    from city_rollup_tpu_torch.rollup.circuits import CircuitToolbox
    from city_rollup_tpu_torch.rollup.queues import Q_NOTIFICATIONS

    srv = net.StoreServer(visibility_timeout_s=45.0)
    srv.start_background()
    procs = []
    try:
        store = net.NetProofStore(srv.host, srv.port)
        hub = net.NetQueueHub(srv.host, srv.port)
        orch, planned = plan_block(om, CityStore, FAST_TEST_PARAMS, store,
                                   hub)
        env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep +
                   os.environ.get("PYTHONPATH", ""))
        procs = [subprocess.Popen(
            [sys.executable, "-m", "city_rollup_tpu_torch.cli", "l2-worker",
             "--store", f"{srv.host}:{srv.port}", "--fast", "--device",
             "cpu", "--batch", "4", "--max-idle", "60"],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, cwd=ROOT) for _ in range(2)]
        killed_after = 0
        seen = ""
        victim = procs[1]
        while True:
            line = victim.stdout.readline()
            if not line:
                break
            seen += line
            if '"processed"' in line:
                killed_after += 1
                victim.kill()
                break
        victim.wait(timeout=60)
        out0, _ = procs[0].communicate(timeout=6 * 3600)
        assert procs[0].returncode == 0, out0[-2000:]
        done0 = [ln for ln in out0.splitlines() if '"processed"' in ln]
        assert '"batched_group"' in out0 + seen, out0[-500:]
        assert len(done0) + killed_after >= planned.num_jobs
        assert hub.receive(Q_NOTIFICATIONS) is not None
        assert orch.finalize(planned, CircuitToolbox(FAST_TEST_PARAMS,
                                                     device="cpu"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        srv.shutdown()
