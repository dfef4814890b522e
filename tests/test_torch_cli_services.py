"""The port's command lines for the fleet (cli.py's service subcommands,
user_cli.py) against the reference's: every subcommand takes the
reference's arguments, plus `--device` where it builds circuits; the
wallet commands read and write the reference's wallet file; the store and
node subcommands serve as subprocesses, the way the card's run starts
them; the orchestrator subcommand plans a block from a produce-block
command."""

import contextlib
import io
import json
import os
import re
import subprocess
import sys

import pytest

from city_rollup_tpu import cli as jcli
from city_rollup_tpu import user_cli as juser_cli
from city_rollup_tpu_torch import cli, user_cli
from city_rollup_tpu_torch.rollup import netstore as net
from city_rollup_tpu_torch.rollup.queues import Q_CMD, Q_JOB
from city_rollup_tpu_torch.rollup.zk_signature import derive_public_key
from city_rollup_tpu_torch.services.node import flush_rpc_requests
from city_rollup_tpu_torch.services.provider import CityRpcProvider
from city_rollup_tpu_torch.services.rpc_common import JsonRpcError

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLI_SUBCOMMANDS = ("full-block", "qbench", "inspect-dump", "sighash-corpus",
                   "print-circuit-info", "store-server", "l2-worker",
                   "api-server", "rpc-server", "user-prover", "orchestrator")
# the subcommands that build or prove circuits
CLI_DEVICE = {"full-block", "qbench", "sighash-corpus", "print-circuit-info",
              "l2-worker", "user-prover", "orchestrator"}
USER_SUBCOMMANDS = ("random-wallet", "get-public-key", "sign-hash",
                    "register-user", "token-transfer", "add-withdrawal",
                    "claim-deposit", "produce-block", "repl")


def arguments(main, argv) -> tuple:
    """(options, positionals) that `main(argv + ["--help"])` lists."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out), pytest.raises(SystemExit) as e:
        main(argv + ["--help"])
    assert e.value.code == 0
    text = out.getvalue()
    options = set(re.findall(r"(?<![\w-])(--[a-z0-9][a-z0-9-]*)", text))
    pos = text.split("positional arguments:")[1].split("options:")[0] \
        if "positional arguments:" in text else ""
    positionals = re.findall(r"^  ([a-z_0-9]+)", pos, re.M)
    return options, positionals


@pytest.mark.parametrize("sub", CLI_SUBCOMMANDS)
def test_cli_subcommands_take_the_references_arguments(sub):
    options, positionals = arguments(cli.main, [sub])
    joptions, jpositionals = arguments(jcli.main, [sub])
    extra = {"--device"} if sub in CLI_DEVICE else set()
    assert options == joptions | extra
    assert positionals == jpositionals


@pytest.mark.parametrize("sub", USER_SUBCOMMANDS)
def test_user_cli_subcommands_take_the_references_arguments(sub):
    options, positionals = arguments(user_cli.main, [sub])
    joptions, jpositionals = arguments(juser_cli.main, [sub])
    extra = {"--device"} if sub == "sign-hash" else set()
    assert options == joptions | extra
    assert positionals == jpositionals


def test_subcommand_lists_equal_the_references():
    for main, jmain in [(cli.main, jcli.main),
                        (user_cli.main, juser_cli.main)]:
        text = io.StringIO()
        jtext = io.StringIO()
        for buf, m in [(text, main), (jtext, jmain)]:
            with contextlib.redirect_stdout(buf), pytest.raises(SystemExit):
                m(["--help"])
        listed, jlisted = [
            re.search(r"\{([a-z0-9,-]+)\}", re.sub(r"\s+", "", b.getvalue()))
            .group(1).split(",") for b in (text, jtext)]
        assert sorted(listed) == sorted(jlisted)
        assert len(listed) == len(CLI_SUBCOMMANDS if main is cli.main
                                  else USER_SUBCOMMANDS)


def test_user_cli_wallet_roundtrip(tmp_path, capsys):
    """The port's random-wallet writes a wallet the reference's
    get-public-key reads to the same key, and the other way round."""
    w = str(tmp_path / "wallet.json")
    assert user_cli.main(["--wallet", w, "random-wallet"]) == 0
    made = json.loads(capsys.readouterr().out)
    assert user_cli.main(["--wallet", w, "get-public-key"]) == 0
    assert json.loads(capsys.readouterr().out) == \
        {"zk_public_key": made["zk_public_key"]}
    assert juser_cli.main(["--wallet", w, "get-public-key"]) == 0
    assert json.loads(capsys.readouterr().out) == \
        {"zk_public_key": made["zk_public_key"]}
    data = json.load(open(w))
    assert len(data["zk_keys"]) == 1 and len(data["zk_keys"][0]) == 4
    assert derive_public_key(data["zk_keys"][0]) == made["zk_public_key"]
    assert juser_cli.main(["--wallet", w, "random-wallet"]) == 0
    capsys.readouterr()
    assert user_cli.main(["--wallet", w, "get-public-key", "--key-index",
                          "1"]) == 0
    assert json.loads(capsys.readouterr().out)["zk_public_key"] == \
        derive_public_key(json.load(open(w))["zk_keys"][1])


def serve(args):
    """A subcommand of the port's CLI started as a subprocess; returns
    (process, the address of its {"listening": ...} line)."""
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep +
               os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen([sys.executable, "-m", "city_rollup_tpu_torch.cli"]
                            + args, stdout=subprocess.PIPE, text=True,
                            cwd=ROOT, env=env)
    line = proc.stdout.readline()
    assert line, f"{args[0]} exited with {proc.wait()}"
    return proc, json.loads(line)["listening"]


def test_store_and_rpc_servers_serve_as_subprocesses(capsys):
    """store-server and rpc-server as the card's run starts them (port 0,
    their address read from their first line): a register through the
    node reaches the store's queue; a signed transfer is refused; the
    user CLI's produce-block enqueues the command."""
    procs = []
    try:
        store_proc, addr = serve(["store-server", "--port", "0"])
        procs.append(store_proc)
        node_proc, url = serve(["rpc-server", "--port", "0", "--store",
                                addr])
        procs.append(node_proc)
        pr = CityRpcProvider(node_url=url)
        assert pr.register_user(7, (1, 2, 3, 4)) == {"queued": True}
        with pytest.raises(JsonRpcError):
            pr.token_transfer(0, 7, 5, signature_proof="aa")
        assert user_cli.main(["--node-url", url, "produce-block"]) == 0
        assert json.loads(capsys.readouterr().out) == {"queued": True}
        host, port = addr.rsplit(":", 1)
        hub = net.NetQueueHub(host, int(port))
        reqs = flush_rpc_requests(hub)
        assert [(r.user_id, r.public_key) for r in reqs.register_users] == \
            [(7, (1, 2, 3, 4))]
        assert reqs.token_transfers == []
        assert hub.receive(Q_CMD)[1] == b"produce_block"
    finally:
        for p in procs:
            p.terminate()
            p.wait(timeout=30)


def test_orchestrator_subcommand_plans_a_block(capsys):
    """orchestrator --fast over a netstore: a produce-block command makes
    it flush the (empty) ingress queues and plan and enqueue block 1;
    with nothing more it exits after --max-idle."""
    srv = net.StoreServer()
    srv.start_background()
    try:
        hub = net.NetQueueHub(srv.host, srv.port)
        hub.dispatch(Q_CMD, b"produce_block")
        assert cli.main(["orchestrator", "--store",
                         f"{srv.host}:{srv.port}", "--fast",
                         "--max-idle", "1", "--device", "cpu"]) == 0
        lines = [json.loads(ln) for ln in
                 capsys.readouterr().out.splitlines()]
        assert lines[0] == {"orchestrator": "ready", "checkpoint": 1}
        assert lines[1]["block"] == 1 and lines[1]["jobs"] > 0
        assert lines[1]["complete"] is False
        assert lines[2] == {"orchestrator": "idle-exit"}
        assert hub.receive(Q_JOB) is not None
    finally:
        srv.shutdown()
