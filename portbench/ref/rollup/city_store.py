"""CityStore: the rollup's versioned state — three height-32 Poseidon Merkle
trees (user / deposit / withdrawal) plus per-block metadata, all
checkpoint-addressed (checkpoint_id = block number).

City root = H(H(user_root, withdrawal_root), deposit_root)
(reference: city_store/src/store/city/root.rs:15-24).

User state occupies two adjacent leaves (uid -> leaves 2*uid, 2*uid+1):
left = [balance, nonce, 0, 0], right = public key — mirroring
CityUserState's encoding (city_rollup_common/src/api/data/store/mod.rs:89-110,
SURVEY.md §2.3). Every mutation returns the DeltaMerkleProof witness its op
circuit consumes (SURVEY.md §2.1 row 8 CityStore methods).

Rollup constants (city_common/src/config/rollup_constants.rs:1-8).

Counterpart of the reference's ``rollup/city_store.py``: a copy.
"""

from __future__ import annotations

import dataclasses

from ..core import poseidon_host
from .kvq import KVQBinaryStore, KVQMemoryStore
from .merkle_model import (Digest, DeltaMerkleProof, MerkleProof,
                           VersionedMerkleTree, ZERO)

# rollup_constants.rs twins
USER_TREE_HEIGHT = 32
DEPOSIT_TREE_HEIGHT = 32
WITHDRAWAL_TREE_HEIGHT = 32

TREE_USER = 1
TREE_DEPOSIT = 2
TREE_WITHDRAWAL = 3


@dataclasses.dataclass
class CityL2BlockState:
    """Per-block counters (CityL2BlockState twin, store/mod.rs:21-31)."""
    checkpoint_id: int = 0
    next_add_withdrawal_id: int = 0
    next_process_withdrawal_id: int = 0
    next_deposit_id: int = 0
    total_deposits_claimed_epoch: int = 0
    next_user_id: int = 0
    end_balance: int = 0


def hash_deposit(txid224: Digest, public_key, value: int) -> Digest:
    """Deposit leaf = Poseidon(txid224(4) ∥ value ∥ pk9) where pk9 is the
    9-felt packing of the 33-byte compressed L1 public key
    (felts.bytes33_to_felts). IDENTICAL to btc.IntrospectionDeposit.hash so
    the add_deposit op's event hash matches what the sighash circuit
    derives from the funding-transaction bytes (introspection_result.rs
    get_hash)."""
    pk = list(public_key)
    assert len(pk) == 9, "public_key must be the 9-felt compressed packing"
    return tuple(poseidon_host.hash_no_pad(
        list(txid224) + [value % poseidon_host.P] + pk))


def hash_withdrawal(address, value: int) -> Digest:
    """Withdrawal leaf VALUE = (value, a0, a1, a2|flag<<48) — the literal
    4-felt packing (NOT a hash), where address is the 3-limb hash160
    packing (felts.hash160_to_felts). IDENTICAL to
    btc.IntrospectionWithdrawal.hash so process_withdrawal's event hash
    matches the sighash circuit's withdrawal parsing."""
    addr = list(address)
    assert len(addr) == 3, "address must be the 3-limb hash160 packing"
    return (value % poseidon_host.P,) + tuple(addr)


CLAIMED_MARKER: Digest = (1, 1, 1, 1)


class CityStore:
    """Versioned rollup state over any KVQ backend."""

    def __init__(self, store: KVQBinaryStore | None = None,
                 user_tree_height: int = USER_TREE_HEIGHT,
                 deposit_tree_height: int = DEPOSIT_TREE_HEIGHT,
                 withdrawal_tree_height: int = WITHDRAWAL_TREE_HEIGHT):
        self.kv = store if store is not None else KVQMemoryStore()
        self.user_tree = VersionedMerkleTree(self.kv, TREE_USER,
                                             user_tree_height)
        self.deposit_tree = VersionedMerkleTree(self.kv, TREE_DEPOSIT,
                                                deposit_tree_height)
        self.withdrawal_tree = VersionedMerkleTree(self.kv, TREE_WITHDRAWAL,
                                                   withdrawal_tree_height)
        self._block_states: dict[int, CityL2BlockState] = {}

    # -- roots ----------------------------------------------------------------
    def get_city_root(self, checkpoint: int) -> Digest:
        u = self.user_tree.get_root(checkpoint)
        w = self.withdrawal_tree.get_root(checkpoint)
        d = self.deposit_tree.get_root(checkpoint)
        uw = poseidon_host.two_to_one(list(u), list(w))
        return tuple(poseidon_host.two_to_one(uw, list(d)))

    # -- block state ----------------------------------------------------------
    def get_block_state(self, checkpoint: int) -> CityL2BlockState:
        if checkpoint in self._block_states:
            return self._block_states[checkpoint]
        best = CityL2BlockState(checkpoint_id=checkpoint)
        for c in sorted(self._block_states):
            if c <= checkpoint:
                prev = self._block_states[c]
                best = dataclasses.replace(prev, checkpoint_id=checkpoint)
        return best

    def set_block_state(self, state: CityL2BlockState) -> None:
        self._block_states[state.checkpoint_id] = state

    # -- user ops (each returns the op circuit's delta witness) ---------------
    def register_user(self, checkpoint: int, user_id: int,
                      public_key: Digest) -> DeltaMerkleProof:
        """Leaf 2*uid+1 <- pk (CRUserRegistrationCircuit witness)."""
        return self.user_tree.set_leaf(2 * user_id + 1, public_key,
                                       checkpoint)

    def get_user_state(self, user_id: int, checkpoint: int
                       ) -> tuple[int, int, Digest]:
        """-> (balance, nonce, public_key)."""
        left = self.user_tree.get_leaf(2 * user_id, checkpoint)
        pk = self.user_tree.get_leaf(2 * user_id + 1, checkpoint)
        return left[0], left[1], pk

    def increment_user_balance(self, checkpoint: int, user_id: int,
                               amount: int) -> DeltaMerkleProof:
        bal, nonce, _ = self.get_user_state(user_id, checkpoint)
        return self.user_tree.set_leaf(
            2 * user_id, (bal + amount, nonce, 0, 0), checkpoint)

    def decrement_user_balance(self, checkpoint: int, user_id: int,
                               amount: int,
                               new_nonce: int | None = None
                               ) -> DeltaMerkleProof:
        bal, nonce, _ = self.get_user_state(user_id, checkpoint)
        assert bal >= amount, f"insufficient balance: {bal} < {amount}"
        if new_nonce is not None:
            assert new_nonce > nonce, "nonce must increase"
            nonce = new_nonce
        return self.user_tree.set_leaf(
            2 * user_id, (bal - amount, nonce, 0, 0), checkpoint)

    def get_user_merkle_proof(self, user_id: int,
                              checkpoint: int) -> MerkleProof:
        return self.user_tree.prove(2 * user_id + 1, checkpoint)

    # -- deposits --------------------------------------------------------------
    def add_deposit(self, checkpoint: int, deposit_id: int, txid224: Digest,
                    public_key: Digest, value: int) -> DeltaMerkleProof:
        leaf = hash_deposit(txid224, public_key, value)
        return self.deposit_tree.set_leaf(deposit_id, leaf, checkpoint)

    def mark_deposit_as_claimed(self, checkpoint: int,
                                deposit_id: int) -> DeltaMerkleProof:
        return self.deposit_tree.set_leaf(deposit_id, CLAIMED_MARKER,
                                          checkpoint)

    # -- withdrawals -------------------------------------------------------------
    def add_withdrawal(self, checkpoint: int, withdrawal_id: int,
                       address: Digest, value: int) -> DeltaMerkleProof:
        leaf = hash_withdrawal(address, value)
        return self.withdrawal_tree.set_leaf(withdrawal_id, leaf, checkpoint)

    def mark_withdrawal_as_completed(self, checkpoint: int,
                                     withdrawal_id: int) -> DeltaMerkleProof:
        return self.withdrawal_tree.set_leaf(withdrawal_id, ZERO, checkpoint)
