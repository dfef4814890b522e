"""Typed RPC client — the reference's city_rollup_rpc_provider
(src/lib.rs:57-310): one object wrapping the node + query endpoints with
typed methods, including tx-submission helpers that sign with a wallet.

Counterpart of the reference's ``services/provider.py``: a copy.
"""

from __future__ import annotations

import dataclasses

from .rpc_common import rpc_call


@dataclasses.dataclass
class CityRpcProvider:
    """`node_url` handles writes (and forwards reads to the API server when
    wired that way); pass `api_url` to hit the query API directly."""
    node_url: str
    api_url: str | None = None

    def _read(self, method: str, params: list | None = None):
        return rpc_call(self.api_url or self.node_url, method, params)

    def _write(self, method: str, params: list | None = None):
        return rpc_call(self.node_url, method, params)

    # -- queries (core_api twin) ----------------------------------------------
    def ping(self):
        return self._read("cr_ping")

    def get_city_root(self, checkpoint: int) -> list[int]:
        return self._read("cr_getCityRoot", [checkpoint])

    def get_user_tree_root(self, checkpoint: int) -> list[int]:
        return self._read("cr_getUserTreeRoot", [checkpoint])

    def get_deposit_tree_root(self, checkpoint: int) -> list[int]:
        return self._read("cr_getDepositTreeRoot", [checkpoint])

    def get_withdrawal_tree_root(self, checkpoint: int) -> list[int]:
        return self._read("cr_getWithdrawalTreeRoot", [checkpoint])

    def get_user_by_id(self, user_id: int, checkpoint: int) -> dict:
        return self._read("cr_getUserById", [user_id, checkpoint])

    def get_user_merkle_proof(self, user_id: int, checkpoint: int) -> dict:
        return self._read("cr_getUserMerkleProofById",
                          [user_id, checkpoint])

    def get_deposit_merkle_proof(self, index: int, checkpoint: int) -> dict:
        return self._read("cr_getDepositMerkleProof", [index, checkpoint])

    def get_withdrawal_merkle_proof(self, index: int,
                                    checkpoint: int) -> dict:
        return self._read("cr_getWithdrawalMerkleProof",
                          [index, checkpoint])

    def get_block_state(self, checkpoint: int) -> dict:
        return self._read("cr_getBlockState", [checkpoint])

    def get_proof_store_value(self, job_hex: str):
        return self._read("cr_getProofStoreValue", [job_hex])

    # -- transactions (core_node twin) ---------------------------------------
    def register_user(self, user_id: int, public_key) -> dict:
        return self._write("cr_registerUser",
                           [user_id, [int(x) for x in public_key]])

    def token_transfer(self, from_user: int, to_user: int, value: int,
                       signature_proof: str | None = None) -> dict:
        return self._write("cr_tokenTransfer",
                           [from_user, to_user, value, signature_proof])

    def claim_deposit(self, user_id: int, deposit_id: int, txid224,
                      public_key, value: int,
                      l1_signature_proof: str | None = None) -> dict:
        return self._write("cr_claimDeposit",
                           [user_id, deposit_id,
                            [int(x) for x in txid224],
                            [int(x) for x in public_key], value,
                            l1_signature_proof])

    def add_withdrawal(self, user_id: int, withdrawal_id: int, address,
                       value: int,
                       signature_proof: str | None = None) -> dict:
        return self._write("cr_addWithdrawal",
                           [user_id, withdrawal_id,
                            [int(x) for x in address], value,
                            signature_proof])

    def produce_block(self) -> dict:
        return self._write("cr_produceBlock")

    # -- signed submission helpers (lib.rs sign_and_send_* role) -------------
    def sign_and_send_token_transfer(self, wallet, pk, params, from_user,
                                     to_user, value: int) -> dict:
        """Signs the transfer action (new_nonce = current + 1, read from
        the API) with the zk wallet and submits."""
        from ..rollup import orchestrator as om
        from ..rollup.circuits import encode_proof
        st = self.get_user_by_id(from_user, self._latest_cp())
        action = om.transfer_action_hash(params, from_user,
                                         st["nonce"] + 1, to_user, value)
        proof = wallet.zk.sign(pk, action)
        return self.token_transfer(from_user, to_user, value,
                                   encode_proof(proof).hex())

    def _latest_cp(self) -> int:
        try:
            return self._read("cr_getLatestBlockState")["checkpoint_id"]
        except Exception:                       # noqa: BLE001
            return 0
