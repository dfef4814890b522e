"""Versioned (copy-on-write) Poseidon Merkle trees over a KVQ store.

Every node write is keyed (table, tree_id, level, index, checkpoint_id);
reads use the KVQ fuzzy ``get_leq`` over the trailing checkpoint bytes, so a
read at checkpoint c sees the newest write at or before c without copying the
tree — any historical root/leaf/proof stays addressable.

Unwritten nodes default to the cached zero-hash ladder zh[level] (the
reference precomputes 128 levels of these: city_crypto cached_zero_hashes.rs;
model: city_store/src/models/kvq_merkle/model.rs:13,38-56, SURVEY.md §2.1
row 8).

Mutations return delta-Merkle proofs (old_root, old_value, new_root,
new_value, index, siblings) — the exact witness the op circuits consume
(city_crypto/src/hash/merkle/core.rs:13-72).

Counterpart of the reference's ``rollup/merkle_model.py``: a copy.
"""

from __future__ import annotations

import dataclasses
import functools
import struct

from ..core import poseidon_host
from .kvq import KVQBinaryStore

Digest = tuple[int, int, int, int]
ZERO: Digest = (0, 0, 0, 0)

_KEY = struct.Struct(">BBBQQ")     # table, tree_id, level, index, checkpoint
_VAL = struct.Struct(">QQQQ")
TABLE_MERKLE_NODE = 1
CHECKPOINT_FUZZY_BYTES = 8


@functools.lru_cache(maxsize=None)
def zero_hashes(height: int) -> tuple[Digest, ...]:
    """zh[level]: hash of an all-zero subtree whose leaves sit at `height`.
    zh[height] = zero leaf; zh[l] = H(zh[l+1], zh[l+1]); zh[0] = empty root."""
    zh = [ZERO] * (height + 1)
    for lvl in range(height - 1, -1, -1):
        zh[lvl] = tuple(poseidon_host.two_to_one(
            list(zh[lvl + 1]), list(zh[lvl + 1])))
    return tuple(zh)


@dataclasses.dataclass(frozen=True)
class MerkleProof:
    root: Digest
    value: Digest
    index: int
    siblings: list[Digest]       # leaf level first

    def verify(self) -> bool:
        return _compute_root(self.value, self.index,
                             self.siblings) == self.root


@dataclasses.dataclass(frozen=True)
class DeltaMerkleProof:
    old_root: Digest
    old_value: Digest
    new_root: Digest
    new_value: Digest
    index: int
    siblings: list[Digest]

    def verify(self) -> bool:
        """Same index+siblings must carry old_value->old_root and
        new_value->new_root (core.rs delta proof check)."""
        return (_compute_root(self.old_value, self.index,
                              self.siblings) == self.old_root
                and _compute_root(self.new_value, self.index,
                                  self.siblings) == self.new_root)


def _compute_root(value: Digest, index: int, siblings: list[Digest]) -> Digest:
    cur = list(value)
    idx = index
    for sib in siblings:
        if idx & 1:
            cur = poseidon_host.two_to_one(list(sib), cur)
        else:
            cur = poseidon_host.two_to_one(cur, list(sib))
        idx >>= 1
    return tuple(cur)


class VersionedMerkleTree:
    """One height-H tree inside a shared KVQ store. Level 0 = root; leaves at
    level `height` with indices in [0, 2^height)."""

    def __init__(self, store: KVQBinaryStore, tree_id: int, height: int):
        self.store = store
        self.tree_id = tree_id
        self.height = height
        self.zh = zero_hashes(height)

    # -- node io -------------------------------------------------------------
    def _key(self, level: int, index: int, checkpoint: int) -> bytes:
        return _KEY.pack(TABLE_MERKLE_NODE, self.tree_id, level, index,
                         checkpoint)

    def get_node(self, level: int, index: int, checkpoint: int) -> Digest:
        raw = self.store.get_leq(self._key(level, index, checkpoint),
                                 CHECKPOINT_FUZZY_BYTES)
        if raw is None:
            return self.zh[level]
        return _VAL.unpack(raw)

    def _set_node(self, level: int, index: int, checkpoint: int, v: Digest):
        self.store.set(self._key(level, index, checkpoint), _VAL.pack(*v))

    # -- queries -------------------------------------------------------------
    def get_root(self, checkpoint: int) -> Digest:
        return self.get_node(0, 0, checkpoint)

    def get_leaf(self, index: int, checkpoint: int) -> Digest:
        return self.get_node(self.height, index, checkpoint)

    def prove(self, index: int, checkpoint: int) -> MerkleProof:
        siblings = []
        idx = index
        for level in range(self.height, 0, -1):
            siblings.append(self.get_node(level, idx ^ 1, checkpoint))
            idx >>= 1
        return MerkleProof(root=self.get_root(checkpoint),
                           value=self.get_leaf(index, checkpoint),
                           index=index, siblings=siblings)

    # -- mutation ------------------------------------------------------------
    def set_leaf(self, index: int, value: Digest,
                 checkpoint: int) -> DeltaMerkleProof:
        """Copy-on-write leaf update at `checkpoint`; ~height Poseidon hashes."""
        assert 0 <= index < (1 << self.height)
        old_root = self.get_root(checkpoint)
        old_value = self.get_leaf(index, checkpoint)
        siblings = []
        cur = tuple(value)
        idx = index
        self._set_node(self.height, index, checkpoint, cur)
        for level in range(self.height, 0, -1):
            sib = self.get_node(level, idx ^ 1, checkpoint)
            siblings.append(sib)
            if idx & 1:
                cur = tuple(poseidon_host.two_to_one(list(sib), list(cur)))
            else:
                cur = tuple(poseidon_host.two_to_one(list(cur), list(sib)))
            idx >>= 1
            self._set_node(level - 1, idx, checkpoint, cur)
        return DeltaMerkleProof(old_root=old_root, old_value=old_value,
                                new_root=cur, new_value=tuple(value),
                                index=index, siblings=siblings)
