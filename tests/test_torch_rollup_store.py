"""The port's rollup control plane (rollup/kvq, merkle_model, city_store,
job_id, tree_planner, treeprover, proof_store, queues, btc; crypto/
qhashout; utils/timers) against the reference's.

The cases of tests/test_rollup_store.py and the host cases of
tests/test_btc.py (all but the whitelist tree, whose module comes with the
sighash slice), run on the port's copies; then the same operations on both
packages, whose roots, delta proofs, job-id bytes, transaction bytes and
felt packings must be equal. Host only: nothing here touches a device."""

import hashlib
import io
import os
import random
import sys
import time

import pytest

from city_rollup_tpu.crypto import felts as jfelts
from city_rollup_tpu.crypto import qhashout as jqhashout
from city_rollup_tpu.rollup import btc as jbtc
from city_rollup_tpu.rollup import city_store as jcity_store
from city_rollup_tpu.rollup import job_id as jjob_id
from city_rollup_tpu.rollup import treeprover as jtreeprover
from city_rollup_tpu_torch.core import poseidon_host
from city_rollup_tpu_torch.crypto import felts as feltenc
from city_rollup_tpu_torch.crypto import qhashout
from city_rollup_tpu_torch.rollup import (btc, city_store, job_id, kvq,
                                          merkle_model, proof_store, queues,
                                          tree_planner, treeprover)
from city_rollup_tpu_torch.utils import DebugTimer, TraceTimer

P = 0xFFFF_FFFF_0000_0001


# -- the port never imports JAX or the reference ------------------------------

PORT_MODULES = [
    "city_rollup_tpu_torch.cli", "city_rollup_tpu_torch.rollup.worker",
    "city_rollup_tpu_torch.rollup.orchestrator",
    "city_rollup_tpu_torch.rollup.qbench",
    "city_rollup_tpu_torch.rollup.circuits",
    "city_rollup_tpu_torch.crypto.qhashout", "city_rollup_tpu_torch.utils"]


def test_port_imports_without_jax_or_the_reference():
    """A fresh interpreter with `jax` and `city_rollup_tpu` blocked in
    sys.modules imports every module of the slice."""
    import subprocess
    code = ("import sys\n"
            "for m in ('jax', 'city_rollup_tpu'):\n"
            "    sys.modules[m] = None\n"
            f"for m in {PORT_MODULES!r}:\n"
            "    __import__(m)\n"
            "bad = [m for m, v in sys.modules.items() if v is not None "
            "and (m in ('jax', 'city_rollup_tpu') or "
            "m.startswith(('jax.', 'city_rollup_tpu.')))]\n"
            "assert not bad, bad\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]


# -- kvq ----------------------------------------------------------------------

def test_kvq_sqlite_backend(tmp_path):
    path = str(tmp_path / "kv.sqlite")
    s = kvq.KVQSqliteStore(path)
    s.set(b"aa\x00\x01", b"v1")
    s.set(b"aa\x00\x05", b"v5")
    s.set(b"ab\x00\x03", b"w3")
    assert s.get(b"aa\x00\x05") == b"v5"
    assert s.get_leq(b"aa\x00\x04", 2) == b"v1"
    assert s.get_leq(b"aa\x00\x09", 2) == b"v5"
    assert s.get_leq(b"ab\x00\x02", 2) is None
    assert s.delete(b"aa\x00\x01") and not s.delete(b"aa\x00\x01")
    s.close()
    s2 = kvq.KVQSqliteStore(path)
    assert s2.get_leq(b"aa\x00\x09", 2) == b"v5"
    t = merkle_model.VersionedMerkleTree(s2, 1, height=4)
    t.set_leaf(3, (7, 7, 7, 7), checkpoint=1)
    assert t.prove(3, 1).verify()
    s2.close()


def test_kvq_get_leq_versioning():
    s = kvq.KVQMemoryStore()

    def key(node, cp):
        return bytes([node]) + cp.to_bytes(8, "big")
    s.set(key(1, 5), b"v5")
    s.set(key(1, 9), b"v9")
    s.set(key(2, 3), b"other")
    assert s.get_leq(key(1, 5), 8) == b"v5"
    assert s.get_leq(key(1, 7), 8) == b"v5"
    assert s.get_leq(key(1, 9), 8) == b"v9"
    assert s.get_leq(key(1, 100), 8) == b"v9"
    assert s.get_leq(key(1, 4), 8) is None
    assert s.get_leq(key(3, 50), 8) is None


# -- versioned merkle tree ----------------------------------------------------

def test_versioned_tree_delta_proofs_and_checkpoints():
    t = merkle_model.VersionedMerkleTree(kvq.KVQMemoryStore(), 1, height=8)
    zh_root = t.get_root(0)
    d1 = t.set_leaf(3, (10, 20, 30, 40), checkpoint=1)
    assert d1.old_root == zh_root and d1.verify()
    d2 = t.set_leaf(200, (1, 2, 3, 4), checkpoint=2)
    assert d2.old_root == d1.new_root and d2.verify()
    assert t.get_root(1) == d1.new_root
    assert t.get_root(2) == d2.new_root
    assert t.get_leaf(3, 1) == (10, 20, 30, 40)
    assert t.get_leaf(200, 1) == merkle_model.ZERO
    p = t.prove(3, 1)
    assert p.root == d1.new_root and p.verify()


def test_zero_hash_ladder_against_manual():
    zh = merkle_model.zero_hashes(3)
    manual = [0, 0, 0, 0]
    for _ in range(3):
        manual = poseidon_host.two_to_one(manual, manual)
    assert zh[0] == tuple(manual)


# -- city store ---------------------------------------------------------------

def test_city_store_user_lifecycle():
    cs = city_store.CityStore()
    root0 = cs.get_city_root(0)
    pk = (11, 22, 33, 44)
    assert cs.register_user(1, user_id=7, public_key=pk).verify()
    assert cs.get_user_state(7, 1)[2] == pk
    cs.increment_user_balance(1, 7, 1000)
    assert cs.get_user_state(7, 1)[0] == 1000
    assert cs.decrement_user_balance(1, 7, 400, new_nonce=5).verify()
    assert cs.get_user_state(7, 1)[:2] == (600, 5)
    with pytest.raises(AssertionError):
        cs.decrement_user_balance(1, 7, 10_000)
    assert cs.get_city_root(1) != root0
    assert cs.get_city_root(0) == root0


def test_city_store_deposit_withdrawal():
    cs = city_store.CityStore()
    pk9 = tuple(range(1, 10))
    assert cs.add_deposit(1, 0, (1, 2, 3, 4), pk9, 5000).verify()
    c = cs.mark_deposit_as_claimed(1, 0)
    assert c.old_value == city_store.hash_deposit((1, 2, 3, 4), pk9, 5000)
    assert cs.add_withdrawal(1, 0, (9, 9, 9), 250).verify()
    assert cs.mark_withdrawal_as_completed(1, 0).verify()


# -- job ids ------------------------------------------------------------------

def test_job_id_roundtrip_and_tree_parent():
    j = job_id.JobID(topic=job_id.JobTopic.GENERATE_STANDARD_PROOF,
                     goal_id=42,
                     circuit_type=job_id.CircuitType.OP_L2_TRANSFER,
                     group_id=1, sub_group_id=0, task_index=9)
    assert job_id.JobID.from_bytes(j.to_bytes()) == j
    assert len(j.to_bytes()) == 24
    p = j.tree_parent()
    assert p.circuit_type == job_id.CircuitType.AGG_L2_TRANSFER
    assert (p.sub_group_id, p.task_index) == (1, 4)
    pp = p.tree_parent()
    assert (pp.sub_group_id, pp.task_index) == (2, 2)
    assert j.counter_id().data_type == job_id.JobDataType.COUNTER


def test_worker_mode_filter():
    g16 = job_id.JobID(job_id.JobTopic.GENERATE_GROTH16_PROOF, 1,
                       job_id.CircuitType.WRAP_FINAL_SIGHASH_PROOF_BLS12381)
    std = job_id.JobID(job_id.JobTopic.GENERATE_STANDARD_PROOF, 1,
                       job_id.CircuitType.OP_L2_TRANSFER)
    assert job_id.WorkerMode.ALL.accepts(g16)
    assert not job_id.WorkerMode.NO_GROTH16.accepts(g16)
    assert job_id.WorkerMode.NO_GROTH16.accepts(std)
    assert not job_id.WorkerMode.ONLY_GROTH16.accepts(std)


# -- tree planner -------------------------------------------------------------

@pytest.mark.parametrize("n,height", [(1, 0), (2, 1), (3, 2), (8, 3),
                                      (9, 4), (64, 6)])
def test_tree_planner_heights(n, height):
    assert tree_planner.tree_height(n) == height


def test_tree_planner_odd_carry():
    levels = tree_planner.plan_binary_tree(5)
    assert [len(lv) for lv in levels] == [3, 2, 1]
    assert levels[0][2].right is None
    assert levels[1][1].right is None


# -- proof store DAG ----------------------------------------------------------

def test_counter_dag_releases_next_jobs():
    ps = proof_store.MemoryProofStore()
    leaves = [job_id.JobID(job_id.JobTopic.GENERATE_STANDARD_PROOF, 1,
                           job_id.CircuitType.OP_L2_TRANSFER,
                           group_id=3, task_index=i) for i in range(4)]
    parent = [leaves[0].tree_parent()]
    ps.write_next_jobs(leaves, parent)
    released = []
    for j in leaves:
        released += ps.on_job_complete(j)
    assert released == parent


def test_multidimensional_jobs_chain_levels():
    ps = proof_store.MemoryProofStore()

    def mk(level, i):
        return job_id.JobID(job_id.JobTopic.GENERATE_STANDARD_PROOF, 1,
                            job_id.CircuitType.AGG_L2_TRANSFER,
                            group_id=1, sub_group_id=level, task_index=i)
    l1 = [mk(1, i) for i in range(2)]
    l2 = [mk(2, 0)]
    done = [job_id.JobID(job_id.JobTopic.NOTIFY_ORCHESTRATOR_COMPLETE, 1,
                         job_id.CircuitType.UNKNOWN)]
    ps.write_multidimensional_jobs([l1, l2], done)
    assert ps.on_job_complete(l1[0]) == []
    assert ps.on_job_complete(l1[1]) == l2
    assert ps.on_job_complete(l2[0]) == done


def test_proof_store_idempotent_and_dump_restore():
    ps = proof_store.MemoryProofStore()
    j = job_id.JobID(job_id.JobTopic.GENERATE_STANDARD_PROOF, 1,
                     job_id.CircuitType.OP_REGISTER_USER)
    ps.set_bytes(j, b"first")
    ps.set_bytes(j, b"second")
    assert ps.get_bytes(j) == b"first"
    ps.write_next_jobs([j], [])
    ps2 = proof_store.MemoryProofStore.restore(ps.dump())
    assert ps2.get_bytes(j) == b"first"
    assert ps2.get_goal(j.counter_id()) == 1


# -- queues -------------------------------------------------------------------

def test_queue_visibility_timeout_redelivery():
    q = queues.MemoryQueue(visibility_timeout_s=0.0)
    q.send(b"job1")
    assert q.receive()[1] == b"job1"
    time.sleep(0.01)
    mid2, msg2 = q.receive()
    assert msg2 == b"job1"
    assert q.ack(mid2)
    assert q.receive() is None


def test_queue_hub_topics():
    hub = queues.QueueHub()
    hub.dispatch(queues.Q_JOB, b"a")
    hub.dispatch(queues.Q_CMD, b"b")
    assert hub.receive(queues.Q_JOB)[1] == b"a"
    assert hub.receive(queues.Q_CMD)[1] == b"b"
    assert hub.receive(queues.Q_NOTIFICATIONS) is None


# -- btc (host cases of tests/test_btc.py) ------------------------------------

def _sha256d(b):
    return hashlib.sha256(hashlib.sha256(b).digest()).digest()


def _mk_tx(mod, n_in=2, n_out=2, script=b"\x51"):
    ins = [mod.BTCTransactionInput(hash=bytes([i]) * 32, index=i,
                                   script=script, sequence=0xFFFFFFFF)
           for i in range(n_in)]
    outs = [mod.BTCTransactionOutput(value=1000 * (i + 1),
                                     script=mod.p2pkh_script(bytes([i]) * 20))
            for i in range(n_out)]
    return mod.BTCTransaction(version=2, inputs=ins, outputs=outs,
                              locktime=0)


def test_tx_serialize_parse_roundtrip():
    tx = _mk_tx(btc)
    data = tx.serialize()
    assert btc.BTCTransaction.parse(data) == tx
    assert tx.txid() == _sha256d(data)


def test_varint_boundaries():
    for n in (0, 1, 0xFC, 0xFD, 0xFFFF, 0x10000, 0xFFFFFFFF, 2**40):
        assert btc.read_varint(io.BytesIO(btc.write_varint(n))) == n


def test_sighash_preimage_structure():
    tx = _mk_tx(btc, n_in=3)
    sub = b"\x76\xa9\x14" + b"\xAA" * 20 + b"\x88\xac"
    pre = btc.sighash_preimage(tx, 1, sub)
    assert pre[-4:] == (1).to_bytes(4, "little")
    parsed = btc.BTCTransaction.parse(pre[:-4])
    assert parsed.inputs[0].script == b""
    assert parsed.inputs[1].script == sub
    assert parsed.inputs[2].script == b""
    assert btc.sighash(tx, 1, sub) == _sha256d(pre)
    assert pre == jbtc.sighash_preimage(_mk_tx(jbtc, n_in=3), 1, sub)


def test_felt252_roundtrip():
    h = bytes(range(31)) + b"\x0f"
    limbs = feltenc.hash256_to_felt252(h)
    assert all(0 <= x < (1 << 63) for x in limbs)
    assert feltenc.felt252_to_hash256(limbs) == h


def test_felt248_and_hash224():
    h = os.urandom(32)
    assert feltenc.felt248_to_hash256(feltenc.hash256_to_felt248(h))[:31] \
        == h[:31]
    l224 = feltenc.hash256_to_hash224(h)
    assert feltenc.hash224_to_bytes(l224) == h[:28]
    assert all(0 <= x < (1 << 56) for x in l224)


def test_hash160_felts_roundtrip():
    h = os.urandom(20)
    back, flag = feltenc.felts_to_hash160(
        feltenc.hash160_to_felts(h, type_flag=1))
    assert back == h and flag == 1


def test_bytes33_felts_roundtrip():
    pk = b"\x02" + os.urandom(32)
    felts = feltenc.bytes33_to_felts(pk)
    assert len(felts) == 9
    assert feltenc.felts_to_bytes33(felts) == pk


def test_block_script_shape():
    state = bytes(32)
    chunks = [bytes([i]) * 80 for i in range(6)]
    script = btc.encode_block_script(state, chunks)
    assert len(script) == 489
    assert script[0] == btc.OP_PUSHBYTES_32
    assert script[1:33] == state
    assert script[37:69] == hashlib.sha256(chunks[0]).digest()
    assert script == jbtc.encode_block_script(state, chunks)


def test_permutation_count_matches_reference():
    ids = btc.generate_id_permutations(4, 4)
    assert len(ids) == 1875
    assert len({i.to_felt() for i in ids}) == 1875
    assert [i.to_felt() for i in ids] == \
        [i.to_felt() for i in jbtc.generate_id_permutations(4, 4)]


def test_introspection_deposit_withdrawal_hashes():
    txid, pk = os.urandom(32), b"\x03" + os.urandom(32)
    dep = btc.IntrospectionDeposit(txid=txid, public_key=pk, value=12345)
    h = dep.hash()
    assert len(h) == 4 and all(isinstance(x, int) for x in h)
    assert list(h) == list(jbtc.IntrospectionDeposit(
        txid=txid, public_key=pk, value=12345).hash())
    pkh = os.urandom(20)
    wd = btc.IntrospectionWithdrawal(script=btc.p2pkh_script(pkh), value=777)
    assert wd.hash()[0] == 777 and len(wd.hash()) == 4
    wd2 = btc.IntrospectionWithdrawal(script=btc.p2sh_script(pkh), value=778)
    assert wd2.hash()[3] >> 48 == 1
    assert list(wd2.hash()) == list(jbtc.IntrospectionWithdrawal(
        script=jbtc.p2sh_script(pkh), value=778).hash())


def test_events_hash_padding():
    e1, e2, e3 = [1, 2, 3, 4], [5, 6, 7, 8], [9, 10, 11, 12]
    assert btc.events_hash([]) == [0, 0, 0, 0]
    expect = poseidon_host.two_to_one(
        poseidon_host.two_to_one(e1, e2),
        poseidon_host.two_to_one(e3, [0, 0, 0, 0]))
    assert btc.events_hash([e1, e2, e3]) == expect


def test_parse_deposits_and_withdrawals():
    fund_block = _mk_tx(btc, n_in=2, n_out=1)
    pk = b"\x02" + os.urandom(32)
    dep_tx = btc.BTCTransaction(
        version=2,
        inputs=[btc.BTCTransactionInput(hash=os.urandom(32), index=0,
                                        script=b"\x47" + os.urandom(71) +
                                        b"\x21" + pk)],
        outputs=[btc.BTCTransactionOutput(value=5000, script=b"\x51")],
        locktime=0)
    deps = btc.parse_deposits([fund_block, dep_tx], block_spend_index=0)
    assert len(deps) == 1
    assert deps[0].public_key == pk and deps[0].value == 5000
    block_tx = _mk_tx(btc, n_in=1, n_out=3)
    wds = btc.parse_withdrawals(block_tx)
    assert len(wds) == 2
    assert wds[0].value == block_tx.outputs[1].value


# -- the same operations on both packages -------------------------------------

def _random_ops(seed: int, n: int = 40) -> list:
    """A seeded op sequence over a height-8 CityStore: registrations,
    credits, debits, deposits, claims, withdrawals, completions, each at a
    rising checkpoint."""
    rng = random.Random(seed)
    ops, users, deps, wds, bal = [], [], [], [], {}
    for i in range(n):
        cp = 1 + i // 4
        kind = rng.choice(["register", "credit", "debit", "deposit", "claim",
                           "withdraw", "complete"])
        if kind == "register" or not users:
            uid = len(users)
            users.append(uid)
            bal[uid] = 0
            ops.append(("register_user", cp, uid,
                        tuple(rng.randrange(P) for _ in range(4))))
        elif kind == "credit":
            uid = rng.choice(users)
            v = rng.randrange(1, 10_000)
            bal[uid] += v
            ops.append(("increment_user_balance", cp, uid, v))
        elif kind == "debit" and any(bal.values()):
            uid = rng.choice([u for u in users if bal[u]])
            v = rng.randrange(1, bal[uid] + 1)
            bal[uid] -= v
            ops.append(("decrement_user_balance", cp, uid, v))
        elif kind == "deposit":
            did = len(deps)
            deps.append(did)
            ops.append(("add_deposit", cp, did,
                        tuple(rng.randrange(P) for _ in range(4)),
                        tuple(rng.randrange(P) for _ in range(9)),
                        rng.randrange(1, 10**8)))
        elif kind == "claim" and deps:
            ops.append(("mark_deposit_as_claimed", cp, deps.pop(0)))
        elif kind == "withdraw":
            wid = len(wds)
            wds.append(wid)
            ops.append(("add_withdrawal", cp, wid,
                        tuple(rng.randrange(1 << 48) for _ in range(3)),
                        rng.randrange(1, 10**6)))
        elif kind == "complete" and wds:
            ops.append(("mark_withdrawal_as_completed", cp, wds.pop(0)))
    return ops


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_city_store_ops_match_the_reference(seed):
    """The same op sequence on both packages' CityStores gives equal delta
    proofs after every op and equal city roots at every checkpoint."""
    port = city_store.CityStore(user_tree_height=8, deposit_tree_height=8,
                                withdrawal_tree_height=8)
    ref = jcity_store.CityStore(user_tree_height=8, deposit_tree_height=8,
                                withdrawal_tree_height=8)
    ops = _random_ops(seed)
    for name, *args in ops:
        d, jd = getattr(port, name)(*args), getattr(ref, name)(*args)
        assert vars(d) == vars(jd), name
        assert d.verify()
    for cp in range(ops[-1][1] + 1):
        assert port.get_city_root(cp) == ref.get_city_root(cp)
    assert city_store.CLAIMED_MARKER == jcity_store.CLAIMED_MARKER


def test_job_id_bytes_match_the_reference():
    rng = random.Random(3)
    for ct in job_id.CircuitType:
        for topic in job_id.JobTopic:
            fields = dict(goal_id=rng.randrange(1 << 32),
                          group_id=rng.randrange(1 << 16),
                          sub_group_id=rng.randrange(1 << 8),
                          task_index=rng.randrange(1 << 16))
            j = job_id.JobID(topic, circuit_type=ct, **fields)
            jj = jjob_id.JobID(jjob_id.JobTopic(int(topic)),
                               circuit_type=jjob_id.CircuitType(int(ct)),
                               **fields)
            assert j.to_bytes() == jj.to_bytes()
            assert j.counter_id().to_bytes() == jj.counter_id().to_bytes()
            assert j.output_proof_id().to_bytes() == \
                jj.output_proof_id().to_bytes()
    assert [(c.name, int(c)) for c in job_id.CircuitType] == \
        [(c.name, int(c)) for c in jjob_id.CircuitType]


def test_tree_inputs_match_the_reference():
    rng = random.Random(4)

    def leaves(mod):
        """8 chained transitions: each starts where the last one ended."""
        r = random.Random(5)
        roots = [tuple(r.randrange(P) for _ in range(4)) for _ in range(9)]
        return [mod.AggStateTransition(
            roots[i], roots[i + 1],
            tuple(r.randrange(P) for _ in range(4))) for i in range(8)]
    got = treeprover.generate_tree_inputs(leaves(treeprover))
    want = jtreeprover.generate_tree_inputs(leaves(jtreeprover))
    assert [[(i.index, vars(i.left), vars(i.right)) for i in lv]
            for lv in got] == \
        [[(i.index, vars(i.left), vars(i.right)) for i in lv] for lv in want]
    t = leaves(treeprover)[rng.randrange(8)]
    assert t.transition_hash() == jtreeprover.AggStateTransition(
        t.start, t.end, t.events).transition_hash()


def test_qhashout_matches_the_reference():
    rng = random.Random(6)
    for _ in range(20):
        v = tuple(rng.randrange(P) for _ in range(4))
        q, jq = qhashout.QHashOut(v), jqhashout.QHashOut(v)
        assert q.to_le_bytes() == jq.to_le_bytes()
        assert q.two_to_one(q).elements == jq.two_to_one(jq).elements
        raw = bytes(rng.randrange(256) for _ in range(32))
        assert qhashout.QHashOut.from_le_bytes(raw).elements == \
            jqhashout.QHashOut.from_le_bytes(raw).elements
        assert qhashout.felt252_from_hash256(raw) == \
            jqhashout.felt252_from_hash256(raw)
        assert qhashout.felt248_from_hash256(raw) == \
            jqhashout.felt248_from_hash256(raw)
        felts = [rng.randrange(P) for _ in range(rng.randrange(1, 12))]
        assert qhashout.QHashOut.hash_many(felts).elements == \
            jqhashout.QHashOut.hash_many(felts).elements
        assert feltenc.hash256_to_felt252(raw) == \
            jfelts.hash256_to_felt252(raw)


def test_trace_timer_laps():
    t = TraceTimer("t", enabled=False)
    t.lap("a")
    t.lap("b")
    assert [m for m, _ in t.laps] == ["a", "b"]
    assert t.total() >= sum(d for _, d in t.laps)
    assert isinstance(DebugTimer("d"), TraceTimer)
