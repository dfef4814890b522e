"""Unified CLI: full-block demo, qbench, dump inspection, circuit info.

Reference role: city_rollup_cli (SURVEY.md §2.1 row 21; clap dispatch
main.rs:23-46). Counterpart of the reference's ``cli.py``: the in-memory
block pipeline, the bench harness and the sighash whitelist corpus, on the
port's prover. The subcommands that need the service modules
(``store-server``, ``l2-worker``, ``api-server``, ``rpc-server``,
``user-prover``, ``orchestrator``, each with its ``--with-signatures``)
come with those modules (ROADMAP A12d).

Every subcommand that proves or builds takes ``--device`` (default
``cuda``; ``cpu`` runs the plain PyTorch versions of the kernels).

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

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
