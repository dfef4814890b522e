"""In-circuit gadgets for the rollup op circuits: delta-Merkle proofs over
the height-32 state trees, user-state leaves, deposit/withdrawal leaf hashes
and signature action hashes.

Reference roles:
- `DeltaMerkleProofGadget` (city_common_circuit/src/hash/merkle/gadgets/
  delta_merkle_proof.rs) — verifies old_value->old_root and
  new_value->new_root along one shared path.
- `UserStateGadget` (city_rollup_circuit/src/state/user/user_state.rs) —
  user leaf = [balance, nonce, 0, 0] (CityUserState encoding,
  city_rollup_common/src/api/data/store/mod.rs:89-110).
- `compute_sig_action_hash_circuit` (city_rollup_circuit/src/introspection/
  gadgets/rollup/signature.rs) — Poseidon(magic, uid, action, nonce, args).

Counterpart of the reference's ``rollup/op_gadgets.py``: a copy.
"""

from __future__ import annotations

import dataclasses

from ..snark.circuit import CircuitBuilder, PartialWitness, Target
from ..snark.gadgets import select_base, split_le_16
from .merkle_model import DeltaMerkleProof

Digest4 = list  # 4 targets


def split_le_bits(b: CircuitBuilder, t: Target, num_bits: int) -> list:
    """t -> num_bits routable little-endian bits, chunked into 16-bit
    BaseSum rows so every bit lands in a routed column (wires 1..16)."""
    if num_bits <= 16:
        bits = split_le_16(b, t)
        # upper bits of the 16-bit row pinned to zero
        for i in range(num_bits, 16):
            b.assert_zero(bits[i])
        return bits[:num_bits]
    n_limbs = (num_bits + 15) // 16
    limbs = [b.add_virtual_target() for _ in range(n_limbs)]

    def gen(pw, _t=t, _limbs=limbs):
        v = pw.get(_t)
        if v is None or pw.get(_limbs[0]) is not None:
            return
        for i, lt in enumerate(_limbs):
            pw.set(lt, (v >> (16 * i)) & 0xFFFF)

    b.add_generator(gen, deps=[t])
    bits = []
    for lt in limbs:
        bits.extend(split_le_16(b, lt))
    acc = limbs[0]
    for i in range(1, n_limbs):
        acc = b.arithmetic(pow(2, 16 * i, 2**64 - 2**32 + 1), 1,
                           limbs[i], b.one(), acc)
    b.connect(acc, t)
    for i in range(num_bits, 16 * n_limbs):
        b.assert_zero(bits[i])
    return bits[:num_bits]


def merkle_root_from_path(b: CircuitBuilder, value: Digest4,
                          index_bits: list, siblings: list) -> Digest4:
    """Walk leaf->root: at level l, bit l picks ordering (bit=1 => current
    node is the right child)."""
    cur = list(value)
    for lvl, sib in enumerate(siblings):
        bit = index_bits[lvl]
        left = [select_base(b, bit, sib[j], cur[j]) for j in range(4)]
        right = [select_base(b, bit, cur[j], sib[j]) for j in range(4)]
        cur = b.hash_two_to_one(left, right)
    return cur


@dataclasses.dataclass
class DeltaMerkleTargets:
    height: int
    index: Target
    index_bits: list
    old_value: Digest4
    new_value: Digest4
    siblings: list          # height x Digest4
    old_root: Digest4
    new_root: Digest4


def add_delta_merkle_gadget(b: CircuitBuilder,
                            height: int) -> DeltaMerkleTargets:
    """Two Merkle walks sharing index bits + siblings: the one-leaf state
    delta every op circuit proves (2*height Poseidon rows)."""
    index = b.add_virtual_target()
    index_bits = split_le_bits(b, index, height)
    old_value = b.add_virtual_hash()
    new_value = b.add_virtual_hash()
    siblings = [b.add_virtual_hash() for _ in range(height)]
    old_root = merkle_root_from_path(b, old_value, index_bits, siblings)
    new_root = merkle_root_from_path(b, new_value, index_bits, siblings)
    return DeltaMerkleTargets(height=height, index=index,
                              index_bits=index_bits, old_value=old_value,
                              new_value=new_value, siblings=siblings,
                              old_root=old_root, new_root=new_root)


def set_delta_merkle_witness(pw: PartialWitness, t: DeltaMerkleTargets,
                             proof: DeltaMerkleProof):
    assert len(proof.siblings) == t.height, \
        f"delta proof height {len(proof.siblings)} != gadget {t.height}"
    pw.set(t.index, proof.index)
    for tt, v in zip(t.old_value, proof.old_value):
        pw.set(tt, int(v))
    for tt, v in zip(t.new_value, proof.new_value):
        pw.set(tt, int(v))
    for st, sib in zip(t.siblings, proof.siblings):
        for tt, v in zip(st, sib):
            pw.set(tt, int(v))


# -- user state leaves --------------------------------------------------------

@dataclasses.dataclass
class UserStateTargets:
    """User left leaf decoded: [balance, nonce, 0, 0]."""
    balance: Target
    nonce: Target


def decode_user_leaf(b: CircuitBuilder, leaf: Digest4) -> UserStateTargets:
    b.assert_zero(leaf[2])
    b.assert_zero(leaf[3])
    return UserStateTargets(balance=leaf[0], nonce=leaf[1])


def user_leaf(b: CircuitBuilder, balance: Target, nonce: Target) -> Digest4:
    return [balance, nonce, b.zero(), b.zero()]


BALANCE_BITS = 62   # balances fit 62 bits (keeps b - a range checks exact)


# -- leaf hashes ---------------------------------------------------------------

def deposit_leaf_hash(b: CircuitBuilder, txid224: list,
                      public_key9: list, value: Target) -> Digest4:
    """Poseidon(txid224(4) ∥ value ∥ pk9(9)) — twin of city_store
    hash_deposit AND of the sighash circuit's in-circuit deposit hash
    (sighash_circuit.py: hash224_of_bytes + [val] + pk33_felts), so deposit
    events agree between the rollup and introspection sides."""
    return b.hash_n_to_hash_no_pad(list(txid224) + [value] +
                                   list(public_key9))


def withdrawal_leaf_hash(b: CircuitBuilder, address3: list,
                         value: Target) -> list:
    """[value, a0, a1, a2|flag<<48] — the literal leaf value, twin of
    city_store hash_withdrawal and the sighash circuit's pkh_felts
    withdrawal packing."""
    return [value] + list(address3)


# -- signature action hashes ---------------------------------------------------

SIG_ACTION_TRANSFER_MAGIC = 0xf_00_01
SIG_ACTION_ADD_WITHDRAWAL_MAGIC = 0xf_00_02
SIG_ACTION_CLAIM_DEPOSIT_MAGIC = 0xf_00_03


def sig_action_hash(b: CircuitBuilder, network_magic: int, user_id: Target,
                    action_id: int, nonce: Target, args: list) -> Digest4:
    """Poseidon(magic, uid, action, nonce, *args) — the message the user's
    signature proof must commit to (sig_action hash, reference
    l2_transfer/circuit.rs:66-73)."""
    inputs = [b.constant(network_magic), user_id, b.constant(action_id),
              nonce] + list(args)
    return b.hash_n_to_hash_no_pad(inputs)


