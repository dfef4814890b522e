"""User CLI — the reference's city_rollup_user_cli (919 LoC incl. repl):
wallet commands (random-wallet, get-public-key, sign-hash), tx submission
(register-user, token-transfer, add-withdrawal, claim-deposit) against a
node/API endpoint, and an interactive repl.

Usage: python -m city_rollup_tpu_torch.user_cli <subcommand> [...]

Wallet files are JSON {"zk_keys": [[felt x4], ...], "secp_keys": [hex]}
stored at --wallet (default ~/.city-rollup-tpu/wallet.json).

Counterpart of the reference's ``user_cli.py``: a copy, over the port's
services. ``sign-hash`` builds and proves the ZK signature wrapper
locally unless given ``--prover-url``, so it takes ``--device``
(default ``cuda``; ``cpu`` runs the plain PyTorch versions of the
kernels)."""

from __future__ import annotations

import argparse
import json
import os
import sys

P = (1 << 64) - (1 << 32) + 1
DEFAULT_WALLET = os.path.expanduser("~/.city-rollup-tpu/wallet.json")


def _load_wallet(path: str) -> dict:
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return {"zk_keys": [], "secp_keys": []}


def _save_wallet(path: str, data: dict):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(data, f, indent=1)


def cmd_random_wallet(args):
    w = _load_wallet(args.wallet)
    sk = [int.from_bytes(os.urandom(8), "little") % P for _ in range(4)]
    w["zk_keys"].append(sk)
    secp_sk = os.urandom(32).hex()
    w["secp_keys"].append(secp_sk)
    _save_wallet(args.wallet, w)
    from .rollup.zk_signature import derive_public_key
    print(json.dumps({"zk_public_key": derive_public_key(sk),
                      "zk_key_index": len(w["zk_keys"]) - 1,
                      "secp_key_index": len(w["secp_keys"]) - 1}))
    return 0


def cmd_get_public_key(args):
    w = _load_wallet(args.wallet)
    from .rollup.zk_signature import derive_public_key
    sk = w["zk_keys"][args.key_index]
    print(json.dumps({"zk_public_key": derive_public_key(sk)}))
    return 0


def cmd_sign_hash(args):
    """Prove a zk signature over a 4-felt action hash; prints the encoded
    proof hex (locally, or via a user-prover service with --prover-url)."""
    w = _load_wallet(args.wallet)
    sk = w["zk_keys"][args.key_index]
    action = [int(x) % P for x in args.action.split(",")]
    assert len(action) == 4, "action must be 4 comma-separated felts"
    if args.prover_url:
        import time
        from .services.rpc_common import rpc_call
        jid = rpc_call(args.prover_url, "cr_proveZkSignature",
                       [sk, action])
        while True:
            st = rpc_call(args.prover_url, "cr_getProof", [jid])
            if st["status"] == "done":
                print(json.dumps({"proof": st["proof"]}))
                return 0
            if st["status"] == "error":
                print(json.dumps(st), file=sys.stderr)
                return 1
            time.sleep(0.5)
    from .rollup.circuits import FAST_TEST_CONFIG, encode_proof
    from .rollup.zk_signature import ZKSignatureWrapperCircuit
    from .snark.config import CircuitConfig
    cfg = FAST_TEST_CONFIG if args.fast else \
        CircuitConfig.poseidon_config()
    wrapper = ZKSignatureWrapperCircuit.build(cfg, device=args.device)
    proof = wrapper.sign(sk, action)
    print(json.dumps({"proof": encode_proof(proof).hex()}))
    return 0


def _provider(args):
    from .services.provider import CityRpcProvider
    return CityRpcProvider(node_url=args.node_url, api_url=args.api_url)


def cmd_register_user(args):
    w = _load_wallet(args.wallet)
    from .rollup.zk_signature import derive_public_key
    pk = derive_public_key(w["zk_keys"][args.key_index])
    print(json.dumps(_provider(args).register_user(args.user_id, pk)))
    return 0


def cmd_token_transfer(args):
    print(json.dumps(_provider(args).token_transfer(
        args.from_user, args.to_user, args.value,
        signature_proof=args.signature_proof)))
    return 0


def cmd_add_withdrawal(args):
    address = [int(x) % P for x in args.address.split(",")]
    print(json.dumps(_provider(args).add_withdrawal(
        args.user_id, args.withdrawal_id, address, args.value,
        signature_proof=args.signature_proof)))
    return 0


def cmd_claim_deposit(args):
    txid224 = [int(x) % P for x in args.txid224.split(",")]
    pk9 = [int(x) % P for x in args.public_key.split(",")]
    print(json.dumps(_provider(args).claim_deposit(
        args.user_id, args.deposit_id, txid224, pk9, args.value,
        l1_signature_proof=args.l1_signature_proof)))
    return 0


def cmd_produce_block(args):
    print(json.dumps(_provider(args).produce_block()))
    return 0


def cmd_repl(args):                                 # pragma: no cover
    """Interactive loop (repl.rs role): `<command> [args...]` per line."""
    print("city-rollup user repl — 'help' lists commands, 'quit' exits")
    while True:
        try:
            line = input("city> ").strip()
        except (EOFError, KeyboardInterrupt):
            return 0
        if not line:
            continue
        if line in ("quit", "exit"):
            return 0
        if line == "help":
            print("commands: random-wallet | get-public-key | sign-hash | "
                  "register-user | token-transfer | add-withdrawal | "
                  "claim-deposit | produce-block | quit")
            continue
        try:
            main(line.split())
        except SystemExit:
            pass
        except Exception as e:                      # noqa: BLE001
            print(f"error: {e!r}")


def main(argv=None):
    p = argparse.ArgumentParser(prog="city_rollup_tpu_torch.user_cli")
    p.add_argument("--wallet", default=DEFAULT_WALLET)
    p.add_argument("--node-url", default="http://127.0.0.1:7444")
    p.add_argument("--api-url", default=None)
    sub = p.add_subparsers(dest="cmd", required=True)

    sub.add_parser("random-wallet").set_defaults(fn=cmd_random_wallet)

    gp = sub.add_parser("get-public-key")
    gp.add_argument("--key-index", type=int, default=0)
    gp.set_defaults(fn=cmd_get_public_key)

    sh = sub.add_parser("sign-hash")
    sh.add_argument("action", help="4 comma-separated felts")
    sh.add_argument("--key-index", type=int, default=0)
    sh.add_argument("--fast", action="store_true")
    sh.add_argument("--prover-url", default=None,
                    help="user-prover service URL (proves remotely)")
    sh.add_argument("--device", default="cuda",
                    help="where a local proof runs: cuda (default) or cpu")
    sh.set_defaults(fn=cmd_sign_hash)

    ru = sub.add_parser("register-user")
    ru.add_argument("user_id", type=int)
    ru.add_argument("--key-index", type=int, default=0)
    ru.set_defaults(fn=cmd_register_user)

    tt = sub.add_parser("token-transfer")
    tt.add_argument("from_user", type=int)
    tt.add_argument("to_user", type=int)
    tt.add_argument("value", type=int)
    tt.add_argument("--signature-proof", default=None)
    tt.set_defaults(fn=cmd_token_transfer)

    aw = sub.add_parser("add-withdrawal")
    aw.add_argument("user_id", type=int)
    aw.add_argument("withdrawal_id", type=int)
    aw.add_argument("address", help="3 comma-separated limbs")
    aw.add_argument("value", type=int)
    aw.add_argument("--signature-proof", default=None)
    aw.set_defaults(fn=cmd_add_withdrawal)

    cd = sub.add_parser("claim-deposit")
    cd.add_argument("user_id", type=int)
    cd.add_argument("deposit_id", type=int)
    cd.add_argument("txid224", help="4 comma-separated felts")
    cd.add_argument("public_key", help="9 comma-separated felts")
    cd.add_argument("value", type=int)
    cd.add_argument("--l1-signature-proof", default=None)
    cd.set_defaults(fn=cmd_claim_deposit)

    sub.add_parser("produce-block").set_defaults(fn=cmd_produce_block)
    sub.add_parser("repl").set_defaults(fn=cmd_repl)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":                          # pragma: no cover
    sys.exit(main())
