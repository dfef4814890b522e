"""Read-only query API server, namespace `cr` — the reference's
city_rollup_core_api (jsonrpsee server, src/lib.rs:27-190): tree roots,
leaves, Merkle proofs, user/block state, city root, and (optionally) raw
proof-store values + job witnesses so external observers can watch proving
progress (SURVEY.md §5 "Metrics/observability").

Counterpart of the reference's ``services/api_server.py``: a copy over
the port's ``CityStore``.
"""

from __future__ import annotations

from ..rollup.city_store import CityStore
from ..rollup.job_id import JobID
from .rpc_common import JsonRpcError, JsonRpcServer


def _digest(d) -> list[int]:
    return [int(x) for x in d]


def make_api_server(city: CityStore, proof_store=None,
                    host: str = "127.0.0.1", port: int = 0,
                    expose_proof_store: bool = True) -> JsonRpcServer:
    srv = JsonRpcServer(host, port)
    m = srv.register

    # -- tree roots / city state (core_api lib.rs getUserTreeRoot etc.) ------
    m("cr_getUserTreeRoot",
      lambda cp: _digest(city.user_tree.get_root(cp)))
    m("cr_getDepositTreeRoot",
      lambda cp: _digest(city.deposit_tree.get_root(cp)))
    m("cr_getWithdrawalTreeRoot",
      lambda cp: _digest(city.withdrawal_tree.get_root(cp)))
    m("cr_getCityRoot", lambda cp: _digest(city.get_city_root(cp)))

    def get_block_state(cp):
        st = city.get_block_state(cp)
        return {"checkpoint_id": st.checkpoint_id,
                "next_add_withdrawal_id": st.next_add_withdrawal_id,
                "next_process_withdrawal_id":
                    st.next_process_withdrawal_id,
                "next_deposit_id": st.next_deposit_id,
                "next_user_id": st.next_user_id,
                "end_balance": st.end_balance}
    def latest_block_state():
        if not city._block_states:
            raise JsonRpcError(-32004, "no block state recorded")
        return get_block_state(max(city._block_states))
    m("cr_getLatestBlockState", latest_block_state)
    m("cr_getBlockState", get_block_state)

    # -- users ----------------------------------------------------------------
    def get_user_by_id(uid, cp):
        bal, nonce, pk = city.get_user_state(uid, cp)
        return {"user_id": uid, "balance": bal, "nonce": nonce,
                "public_key": _digest(pk)}
    m("cr_getUserById", get_user_by_id)

    def user_merkle_proof(uid, cp):
        pr = city.get_user_merkle_proof(uid, cp)
        return {"root": _digest(pr.root), "value": _digest(pr.value),
                "index": pr.index,
                "siblings": [_digest(s) for s in pr.siblings]}
    m("cr_getUserMerkleProofById", user_merkle_proof)

    # -- deposits / withdrawals ----------------------------------------------
    def tree_leaf(tree, idx, cp):
        return _digest(tree.get_leaf(idx, cp))
    m("cr_getDepositLeaf",
      lambda idx, cp: tree_leaf(city.deposit_tree, idx, cp))
    m("cr_getWithdrawalLeaf",
      lambda idx, cp: tree_leaf(city.withdrawal_tree, idx, cp))

    def tree_proof(tree, idx, cp):
        pr = tree.prove(idx, cp)
        return {"root": _digest(pr.root), "value": _digest(pr.value),
                "index": pr.index,
                "siblings": [_digest(s) for s in pr.siblings]}
    m("cr_getDepositMerkleProof",
      lambda idx, cp: tree_proof(city.deposit_tree, idx, cp))
    m("cr_getWithdrawalMerkleProof",
      lambda idx, cp: tree_proof(city.withdrawal_tree, idx, cp))

    # -- proof store inspection (lib.rs:171-190, expose_proof_store_api) -----
    if proof_store is not None and expose_proof_store:
        def ps_value(job_hex):
            v = proof_store.get_bytes(
                JobID.from_bytes(bytes.fromhex(job_hex)))
            return v.hex() if v is not None else None
        m("cr_getProofStoreValue", ps_value)
        m("cr_getProofStoreValues",
          lambda jobs: [ps_value(j) for j in jobs])

        def job_witness(job_hex):
            jid = JobID.from_bytes(bytes.fromhex(job_hex))
            v = proof_store.get_bytes(jid.input_witness_id())
            return v.decode() if v is not None else None
        m("cr_getProofStoreJobWitness", job_witness)
        m("cr_getProofStoreJobWitnesses",
          lambda jobs: [job_witness(j) for j in jobs])

    m("cr_ping", lambda: "pong")
    return srv
