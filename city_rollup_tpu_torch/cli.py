"""Unified CLI: full-block demo, qbench, dump inspection, circuit info, and
the proving fleet's services.

Reference role: city_rollup_cli (SURVEY.md §2.1 row 21; clap dispatch
main.rs:23-46). Counterpart of the reference's ``cli.py``: the in-memory
block pipeline, the bench harness, the sighash whitelist corpus and the
fleet (``store-server``, ``l2-worker``, ``api-server``, ``rpc-server``,
``user-prover``, ``orchestrator``), on the port's prover.

Every subcommand that proves or builds circuits takes ``--device``
(default ``cuda``; ``cpu`` runs the plain PyTorch versions of the
kernels): ``l2-worker``, ``user-prover`` and ``orchestrator`` among the
services (the orchestrator builds the ZK signature wrapper with
``--with-signatures``). As in the reference, ``l2-worker`` builds a
``CircuitToolbox`` and no sighash toolbox, so it leaves the SIGHASH_* and
WRAP_* jobs of a block planned with an L1 context to a worker that has one.

Usage: python -m city_rollup_tpu_torch.cli <subcommand> [...]
"""

from __future__ import annotations

import argparse
import json
import sys

# the CLI's demo block (full_block.rs twin): genesis at checkpoint 0, then
# one block of a register, three transfers and a withdrawal
DEMO_GENESIS_BALANCE = 10_000
DEMO_TRANSFERS = (250, 100, 50)


def demo_genesis(city, params):
    """Two registered users at checkpoint 0, user 0 funded and user 1
    pre-funded with the withdrawal fee (withdrawals debit value + fee)."""
    city.register_user(0, 0, (1, 1, 1, 1))
    city.register_user(0, 1, (2, 2, 2, 2))
    city.increment_user_balance(0, 0, DEMO_GENESIS_BALANCE)
    city.increment_user_balance(0, 1, params.withdrawal_fee)


def demo_requests():
    """The demo block's requests (checkpoint 1)."""
    from .rollup import orchestrator as om
    return om.BlockRequests(
        register_users=[om.RegisterUser(2, (3, 3, 3, 3))],
        token_transfers=[om.TokenTransfer(0, 1, v) for v in DEMO_TRANSFERS],
        add_withdrawals=[om.AddWithdrawal(1, 0, (9, 9, 9), 25)],
    )


def _params(args):
    from .rollup.circuits import DEFAULT_PARAMS, FAST_TEST_PARAMS
    return FAST_TEST_PARAMS if args.fast else DEFAULT_PARAMS


def cmd_full_block(args):
    """Prove a demo block end-to-end in memory (full_block.rs twin)."""
    from .rollup import orchestrator as om
    from .rollup.circuits import CircuitToolbox
    from .rollup.city_store import CityStore
    from .rollup.proof_store import MemoryProofStore
    from .rollup.queues import QueueHub
    from .rollup.worker import Worker
    from .utils import TraceTimer

    t = TraceTimer("full_block")
    params = _params(args)
    city = CityStore(user_tree_height=params.user_tree_height,
                     deposit_tree_height=params.deposit_tree_height,
                     withdrawal_tree_height=params.withdrawal_tree_height)
    store = MemoryProofStore()
    hub = QueueHub()
    toolbox = CircuitToolbox(params, device=args.device)
    orch = om.Orchestrator(city, store, hub, params=params)
    demo_genesis(city, params)
    t.lap("genesis")
    planned = orch.plan_block(1, demo_requests())
    orch.enqueue(planned)
    t.lap(f"planned block ({planned.num_jobs} jobs)")
    worker = Worker(toolbox, store, hub)
    while worker.process_next_job():
        pass
    t.lap("proved all jobs")
    ok = orch.finalize(planned, toolbox)
    t.lap(f"finalized: {ok}")
    if args.dump:
        from .rollup.qbench import dump_block
        with open(args.dump, "w") as f:
            f.write(dump_block(store, planned).to_json())
        t.event(f"dumped proof store to {args.dump}")
    print(json.dumps({"ok": ok, "jobs": planned.num_jobs,
                      "total_s": round(t.total(), 3)}))
    return 0 if ok else 1


def cmd_qbench(args):
    from .rollup.circuits import CircuitToolbox
    from .rollup.qbench import BlockProofStoreDump, run_worker_qbench
    with open(args.input) as f:
        dump = BlockProofStoreDump.from_json(f.read())
    toolbox = CircuitToolbox(_params(args), device=args.device)
    results = run_worker_qbench(dump, toolbox, num_rounds=args.rounds,
                                batch=args.batch)
    print(json.dumps(results, indent=None))
    return 0


def cmd_sighash_corpus(args):
    """Resumable offline sighash-whitelist fingerprint generation
    (rollup/sighash_corpus.py; reference sighash_wrapper_config.rs:24's
    precomputed 1,875-entry table). Shard with --start/--count; re-running
    with the same --out resumes."""
    from .rollup import btc, sighash_corpus
    params = _params(args)
    if args.dev_covenant:
        spend_cfg = btc.dev_spend_cfg()
        body = btc.DEV_SCRIPT_BODY
    else:
        spend_cfg = btc.BlockSpendCoreConfig()
        body = bytes.fromhex(args.script_body or "")
        assert len(body) + 33 == spend_cfg.block_sighash_script_size, \
            "--script-body must be the production covenant body"

    def progress(i, total, gid, fp):
        print(json.dumps({"i": i, "total": total,
                          "gid": gid.to_felt(), "fp0": str(fp[0])}),
              flush=True)

    corpus = sighash_corpus.generate(
        params.config, spend_cfg, body, args.out,
        start=args.start, count=args.count, progress=progress,
        device=args.device)
    root = corpus.whitelist_root()
    print(json.dumps({"entries": len(corpus.fps), "of": 1875,
                      "whitelist_root": [str(x) for x in root]}))
    return 0


def cmd_inspect_dump(args):
    from .rollup.qbench import BlockProofStoreDump
    with open(args.input) as f:
        dump = BlockProofStoreDump.from_json(f.read())
    print(json.dumps({
        "leaf_jobs": len(dump.leaf_jobs),
        "entries": len(dump.store_dump["data"]),
        "counters": len(dump.store_dump["counters"])}))
    return 0


def cmd_circuit_info(args):
    """print-circuit-info twin (dev_cli print_circuit_info subcommand)."""
    from .rollup.circuits import (CircuitToolbox, FAMILY_BY_AGG,
                                  FAMILY_BY_DUMMY, OP_NAME_BY_TYPE)
    from .rollup.job_id import CircuitType
    from .snark.recursion import fingerprint_verifier_data
    toolbox = CircuitToolbox(_params(args), device=args.device)
    ct = CircuitType[args.circuit]
    if ct in OP_NAME_BY_TYPE:
        name = OP_NAME_BY_TYPE[ct]
        data = toolbox._family_for(name).leaves[name].data
    elif ct in FAMILY_BY_AGG:
        data = toolbox._family_for(FAMILY_BY_AGG[ct]).agg.data
    elif ct in FAMILY_BY_DUMMY:
        data = toolbox._family_for(FAMILY_BY_DUMMY[ct]).dummy.data
    elif ct == CircuitType.BLOCK_AGG_STATE_PART_1:
        data = toolbox.block["part1"][0]
    elif ct == CircuitType.BLOCK_AGG_STATE_PART_2:
        data = toolbox.block["part2"][0]
    elif ct == CircuitType.BLOCK_STATE_TRANSITION:
        data = toolbox.block["transition"][0]
    else:
        print(json.dumps({"error": f"no toolbox circuit for {args.circuit}"}))
        return 1
    c = data.common
    print(json.dumps({
        "circuit": args.circuit,
        "degree": c.n,
        "log_degree": c.log_n,
        "gates": [g.key for g in c.gates],
        "num_public_inputs": c.num_public_inputs,
        "fingerprint": [hex(x) for x in
                        fingerprint_verifier_data(data.verifier)],
    }))
    return 0


def cmd_store_server(args):
    """Run the networked proof-store/queue server (the Redis stand-in —
    reference `redis` dependency of every service, SURVEY.md §2.11)."""
    from .rollup.netstore import StoreServer
    srv = StoreServer(args.host, args.port, args.visibility_timeout)
    print(json.dumps({"listening": f"{srv.host}:{srv.port}"}), flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        return 0
    return 0


def cmd_l2_worker(args):
    """Run a proving worker against a networked store (reference
    `city_rollup_cli l2-worker`, SURVEY.md §3.1)."""
    import time
    from .rollup.circuits import CircuitToolbox
    from .rollup.job_id import WorkerMode
    from .rollup.netstore import NetProofStore, NetQueueHub
    from .rollup.worker import Worker

    host, port = args.store.rsplit(":", 1)
    store = NetProofStore(host, int(port))
    hub = NetQueueHub(host, int(port))
    toolbox = CircuitToolbox(_params(args),
                             with_signatures=args.with_signatures,
                             device=args.device)
    toolbox.prewarm()
    mode = WorkerMode[args.mode.upper().replace("-", "_")]
    worker = Worker(toolbox, store, hub, mode=mode)
    print(json.dumps({"worker": "ready", "mode": args.mode}), flush=True)
    idle_since = time.monotonic()
    groups_seen = 0
    while True:
        if args.batch > 1:
            done = worker.process_ready_batch(max_batch=args.batch)
        else:
            done = 1 if worker.process_next_job() else 0
        if done:
            idle_since = time.monotonic()
            for gsz in worker.batched_groups[groups_seen:]:
                if gsz > 1:
                    print(json.dumps({"batched_group": gsz}), flush=True)
            groups_seen = len(worker.batched_groups)
            for bm in worker.benchmarks[-done:]:
                print(json.dumps({"processed": bm.job_id,
                                  "ms": round(bm.duration_ms, 1)}),
                      flush=True)
        else:
            if args.max_idle and \
                    time.monotonic() - idle_since > args.max_idle:
                break
            time.sleep(args.poll_interval)
    print(json.dumps({"worker": "idle-exit",
                      "jobs": len(worker.benchmarks)}), flush=True)
    return 0


def cmd_api_server(args):
    """Read-only query API (city_rollup_core_api role). Point --state at
    the orchestrator's sqlite KVQ file to serve REAL rollup state; without
    it the server answers from an empty in-memory store (genesis-only —
    fine for smoke tests, wrong next to a live rollup)."""
    from .rollup.city_store import CityStore
    from .rollup.kvq import KVQSqliteStore
    from .rollup.netstore import NetProofStore
    from .services.api_server import make_api_server
    if args.state:
        city = CityStore(store=KVQSqliteStore(args.state))
    else:
        city = CityStore()
    proof_store = None
    if args.store:
        host, port = args.store.rsplit(":", 1)
        proof_store = NetProofStore(host, int(port))
    srv = make_api_server(city, proof_store, args.host, args.port)
    print(json.dumps({"listening": srv.url}), flush=True)
    srv.serve_forever()
    return 0


def cmd_rpc_server(args):
    """Tx-ingress JSON-RPC node (city_rollup_core_node role)."""
    from .rollup.netstore import NetQueueHub
    from .services.node import make_node_server
    host, port = args.store.rsplit(":", 1)
    hub = NetQueueHub(host, int(port))
    srv = make_node_server(
        hub, args.host, args.port, api_url=args.api_url,
        fleet_verifies_signatures=args.with_signatures)
    print(json.dumps({"listening": srv.url}), flush=True)
    srv.serve_forever()
    return 0


def cmd_user_prover(args):
    """User signature-proving service (city_rollup_user_prover_api role)."""
    from .rollup.zk_signature import ZKSignatureWrapperCircuit
    from .services.user_prover import make_user_prover_server
    wrapper = ZKSignatureWrapperCircuit.build(_params(args).config,
                                              device=args.device)
    srv = make_user_prover_server(wrapper, host=args.host, port=args.port)
    print(json.dumps({"listening": srv.url}), flush=True)
    srv.serve_forever()
    return 0


def cmd_orchestrator(args):
    """Block-production service loop (reference `city_rollup_cli
    orchestrator`, sync_infinite_loop): wait for produce-block commands,
    flush the RPC ingress queues, plan + enqueue the DAG against the
    shared netstore, await completion, record block state."""
    from .rollup import orchestrator as om
    from .rollup.city_store import CityStore
    from .rollup.kvq import KVQSqliteStore
    from .rollup.netstore import NetProofStore, NetQueueHub
    from .services.orchestrator_service import (produce_one_block,
                                                wait_for_produce_block)

    host, port = args.store.rsplit(":", 1)
    store = NetProofStore(host, int(port))
    hub = NetQueueHub(host, int(port))
    params = _params(args)
    if args.with_signatures:
        import dataclasses as _dc
        from .rollup.zk_signature import ZKSignatureWrapperCircuit
        params = _dc.replace(
            params, sig_wrapper=ZKSignatureWrapperCircuit.build(
                params.config, device=args.device).data)
    city = CityStore(
        store=KVQSqliteStore(args.state) if args.state else None,
        user_tree_height=params.user_tree_height,
        deposit_tree_height=params.deposit_tree_height,
        withdrawal_tree_height=params.withdrawal_tree_height)
    orch = om.Orchestrator(city, store, hub, params=params)
    checkpoint = args.start_checkpoint
    print(json.dumps({"orchestrator": "ready",
                      "checkpoint": checkpoint}), flush=True)
    while True:
        if not wait_for_produce_block(hub, timeout_s=args.max_idle or None):
            print(json.dumps({"orchestrator": "idle-exit"}), flush=True)
            return 0
        planned, done = produce_one_block(
            orch, hub, checkpoint, timeout_s=args.block_timeout)
        print(json.dumps({"block": checkpoint, "jobs": planned.num_jobs,
                          "complete": bool(done)}), flush=True)
        checkpoint += 1


def main(argv=None):
    p = argparse.ArgumentParser(prog="city_rollup_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    def with_device(sp):
        sp.add_argument("--device", default="cuda",
                        help="where proofs run: cuda (default) or cpu")
        return sp

    fb = with_device(sub.add_parser("full-block",
                                    help="prove a demo block in memory"))
    fb.add_argument("--fast", action="store_true")
    fb.add_argument("--dump", help="write a qbench-replayable dump here")
    fb.set_defaults(fn=cmd_full_block)

    qb = with_device(sub.add_parser(
        "qbench", help="replay a dumped block proof store"))
    qb.add_argument("input")
    qb.add_argument("--rounds", type=int, default=1)
    qb.add_argument("--fast", action="store_true")
    qb.add_argument("--batch", type=int, default=1,
                    help="drain via the batched-prove path")
    qb.set_defaults(fn=cmd_qbench)

    ins = sub.add_parser("inspect-dump")
    ins.add_argument("input")
    ins.set_defaults(fn=cmd_inspect_dump)

    sc = with_device(sub.add_parser(
        "sighash-corpus",
        help="precompute whitelist fingerprints (resumable)"))
    sc.add_argument("--out", required=True)
    sc.add_argument("--start", type=int, default=0)
    sc.add_argument("--count", type=int, default=None)
    sc.add_argument("--fast", action="store_true")
    sc.add_argument("--dev-covenant", action="store_true",
                    help="dev-tier shrunken covenant (test fixture)")
    sc.add_argument("--script-body", default=None,
                    help="production covenant body hex")
    sc.set_defaults(fn=cmd_sighash_corpus)

    ci = with_device(sub.add_parser("print-circuit-info"))
    ci.add_argument("circuit", help="e.g. OP_L2_TRANSFER")
    ci.add_argument("--fast", action="store_true")
    ci.set_defaults(fn=cmd_circuit_info)

    ss = sub.add_parser("store-server",
                        help="networked proof store + queues (Redis role)")
    ss.add_argument("--host", default="127.0.0.1")
    ss.add_argument("--port", type=int, default=7450)
    ss.add_argument("--visibility-timeout", type=float, default=600.0)
    ss.set_defaults(fn=cmd_store_server)

    lw = with_device(sub.add_parser("l2-worker",
                                    help="proving worker over a netstore"))
    lw.add_argument("--store", default="127.0.0.1:7450", help="host:port")
    lw.add_argument("--fast", action="store_true")
    lw.add_argument("--mode", default="all",
                    choices=["all", "no_groth16", "only_groth16"])
    lw.add_argument("--max-idle", type=float, default=0.0,
                    help="exit after this many idle seconds (0 = never)")
    lw.add_argument("--poll-interval", type=float, default=0.25)
    lw.add_argument("--with-signatures", action="store_true",
                    help="verify user signature proofs in-circuit (builds "
                         "the zk-signature wrapper; fleet-wide setting — "
                         "orchestrator and all workers must agree)")
    lw.add_argument("--batch", type=int, default=1,
                    help="group same-circuit ready jobs into one batched "
                         "device call (prove_batch)")
    lw.set_defaults(fn=cmd_l2_worker)

    asrv = sub.add_parser("api-server", help="read-only query API")
    asrv.add_argument("--host", default="127.0.0.1")
    asrv.add_argument("--port", type=int, default=7445)
    asrv.add_argument("--store", default=None,
                      help="netstore host:port for proof-store inspection")
    asrv.add_argument("--state", default=None,
                      help="shared sqlite KVQ file with the rollup state")
    asrv.set_defaults(fn=cmd_api_server)

    rsrv = sub.add_parser("rpc-server", help="tx-ingress JSON-RPC node")
    rsrv.add_argument("--host", default="127.0.0.1")
    rsrv.add_argument("--port", type=int, default=7444)
    rsrv.add_argument("--store", default="127.0.0.1:7450",
                      help="netstore host:port (queues)")
    rsrv.add_argument("--with-signatures", action="store_true",
                      help="the fleet verifies signature proofs in-circuit; "
                           "without this, signature-bearing requests are "
                           "rejected rather than silently unverified")
    rsrv.add_argument("--api-url", default=None,
                      help="forward unknown methods here")
    rsrv.set_defaults(fn=cmd_rpc_server)

    up = with_device(sub.add_parser("user-prover",
                                    help="user signature proving service"))
    up.add_argument("--host", default="127.0.0.1")
    up.add_argument("--port", type=int, default=7446)
    up.add_argument("--fast", action="store_true")
    up.set_defaults(fn=cmd_user_prover)

    orc = with_device(sub.add_parser("orchestrator",
                                     help="block production service"))
    orc.add_argument("--store", default="127.0.0.1:7450", help="netstore")
    orc.add_argument("--state", default=None,
                     help="sqlite KVQ file for durable rollup state")
    orc.add_argument("--fast", action="store_true")
    orc.add_argument("--with-signatures", action="store_true",
                     help="plan against signature-verifying op circuits "
                          "(must match the workers' --with-signatures)")
    orc.add_argument("--start-checkpoint", type=int, default=1)
    orc.add_argument("--block-timeout", type=float, default=None,
                     help="seconds to await block completion (None: don't)")
    orc.add_argument("--max-idle", type=float, default=0.0,
                     help="exit if no produce-block arrives (0 = wait forever)")
    orc.set_defaults(fn=cmd_orchestrator)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
