"""Tx-ingress RPC node — the reference's city_rollup_core_node
(src/handler.rs:83-140,207-245): user-facing JSON-RPC methods that validate
a request's shape and push it onto the per-kind RPC ingress queues for the
orchestrator to flush at the next block; `cr_produceBlock` enqueues the
produce-block command (Q_CMD); unknown methods forward to the query API.

Counterpart of the reference's ``services/node.py``: a copy over the
port's orchestrator requests.
"""

from __future__ import annotations

import dataclasses
import json

from ..rollup import orchestrator as orch_mod
from ..rollup.queues import (Q_CMD, Q_RPC_ADD_WITHDRAWAL,
                             Q_RPC_CLAIM_DEPOSIT, Q_RPC_REGISTER_USER,
                             Q_RPC_TOKEN_TRANSFER)
from .rpc_common import JsonRpcError, JsonRpcServer

PRODUCE_BLOCK_CMD = b"produce_block"


def _enc(req) -> bytes:
    return json.dumps(dataclasses.asdict(req)).encode()


def make_node_server(hub, host: str = "127.0.0.1", port: int = 0,
                     api_url: str | None = None,
                     fleet_verifies_signatures: bool = False
                     ) -> JsonRpcServer:
    """`hub`: any QueueHub-compatible dispatcher (in-memory or NetQueueHub).

    `fleet_verifies_signatures`: whether the proving fleet was built with
    `CircuitToolbox(..., with_signatures=True)`. When False, any request
    that carries a signature proof is REJECTED instead of silently queued
    with the proof ignored — a fleet without in-circuit verification would
    prove the transfer regardless, misleading the submitter into thinking
    the signature mattered (reference gates this path on the zk-signature
    wrapper being in the toolbox, circuits.rs:87-95)."""
    srv = JsonRpcServer(host, port, forward_to=api_url)

    def _check_sig(proof):
        if proof is not None and not fleet_verifies_signatures:
            raise JsonRpcError(
                -32011,
                "this fleet runs without in-circuit signature verification "
                "(start workers/orchestrator with --with-signatures); "
                "refusing a signature-bearing request the provers would "
                "silently ignore")

    @srv.method("cr_registerUser")
    def register_user(user_id, public_key):
        if len(public_key) != 4:
            raise JsonRpcError(-32602, "public_key must be 4 felts")
        req = orch_mod.RegisterUser(int(user_id),
                                    tuple(int(x) for x in public_key))
        hub.dispatch(Q_RPC_REGISTER_USER, _enc(req))
        return {"queued": True}

    @srv.method("cr_tokenTransfer")
    def token_transfer(from_user, to_user, value, signature_proof=None):
        _check_sig(signature_proof)
        req = orch_mod.TokenTransfer(int(from_user), int(to_user),
                                     int(value),
                                     signature_proof=signature_proof)
        hub.dispatch(Q_RPC_TOKEN_TRANSFER, _enc(req))
        return {"queued": True}

    @srv.method("cr_claimDeposit")
    def claim_deposit(user_id, deposit_id, txid224, public_key, value,
                      l1_signature_proof=None):
        _check_sig(l1_signature_proof)
        if len(public_key) != 9:
            raise JsonRpcError(-32602,
                               "public_key must be the 9-felt packing")
        req = orch_mod.ClaimDeposit(
            int(user_id), int(deposit_id),
            tuple(int(x) for x in txid224),
            tuple(int(x) for x in public_key), int(value),
            l1_signature_proof=l1_signature_proof)
        hub.dispatch(Q_RPC_CLAIM_DEPOSIT, _enc(req))
        return {"queued": True}

    @srv.method("cr_addWithdrawal")
    def add_withdrawal(user_id, withdrawal_id, address, value,
                       signature_proof=None):
        _check_sig(signature_proof)
        if len(address) != 3:
            raise JsonRpcError(-32602, "address must be the 3-limb packing")
        req = orch_mod.AddWithdrawal(
            int(user_id), int(withdrawal_id),
            tuple(int(x) for x in address), int(value),
            signature_proof=signature_proof)
        hub.dispatch(Q_RPC_ADD_WITHDRAWAL, _enc(req))
        return {"queued": True}

    @srv.method("cr_produceBlock")
    def produce_block():
        hub.dispatch(Q_CMD, PRODUCE_BLOCK_CMD)
        return {"queued": True}

    return srv


# -- orchestrator-side flush (actors/rpc_processor.rs role) --------------------

_REQ_TYPES = {
    Q_RPC_REGISTER_USER: orch_mod.RegisterUser,
    Q_RPC_CLAIM_DEPOSIT: orch_mod.ClaimDeposit,
    Q_RPC_TOKEN_TRANSFER: orch_mod.TokenTransfer,
    Q_RPC_ADD_WITHDRAWAL: orch_mod.AddWithdrawal,
}


def flush_rpc_requests(hub) -> orch_mod.BlockRequests:
    """Drain all RPC ingress queues into a BlockRequests (the orchestrator's
    flush_{register_users,claim_deposits,...} step, actors/simple.rs)."""
    out = orch_mod.BlockRequests()
    dest = {
        Q_RPC_REGISTER_USER: out.register_users,
        Q_RPC_CLAIM_DEPOSIT: out.claim_deposits,
        Q_RPC_TOKEN_TRANSFER: out.token_transfers,
        Q_RPC_ADD_WITHDRAWAL: out.add_withdrawals,
    }
    for topic, cls in _REQ_TYPES.items():
        while True:
            got = hub.receive(topic)
            if got is None:
                break
            mid, msg = got
            d = json.loads(msg.decode())
            for k, v in d.items():
                if isinstance(v, list):
                    d[k] = tuple(v)
            dest[topic].append(cls(**d))
            hub.ack(topic, mid)
    return out
