"""SigHash whitelist Merkle tree: a height-16 Poseidon tree whose leaves
are the fingerprints of every admissible sighash-introspection circuit
shape. The sighash wrapper circuit verifies (inner proof, Merkle inclusion
of its circuit fingerprint in this tree).

Reference: `SigHashMerkleTree` (city_store/src/store/sighash/mod.rs:24-85)
over the 1,875 precomputed fingerprints of
city_rollup_common/src/config/sighash_wrapper_config.rs:24 (SURVEY.md §2.5),
with the `SIGHASH_WHITELIST_DISABLED_DEV_MODE` escape hatch
(sighash_wrapper_config.rs:11).

Counterpart of the reference's ``rollup/sighash_tree.py``: a copy.
"""

from __future__ import annotations

import dataclasses

from ..core import poseidon_host
from .merkle_model import MerkleProof, zero_hashes

SIGHASH_WHITELIST_TREE_HEIGHT = 16
# dev-mode: wrapper skips the whitelist inclusion check (reference
# sighash_wrapper.rs:98-102)
SIGHASH_WHITELIST_DISABLED_DEV_MODE = False


@dataclasses.dataclass
class SigHashMerkleTree:
    """Immutable whitelist tree built once from the fingerprint list."""
    height: int
    leaves: list                      # list of 4-felt fingerprints
    levels: list                      # levels[0] = padded leaves ... root

    @classmethod
    def build(cls, fingerprints: list,
              height: int = SIGHASH_WHITELIST_TREE_HEIGHT
              ) -> "SigHashMerkleTree":
        assert len(fingerprints) <= (1 << height)
        zh = zero_hashes(height)
        cur = [tuple(int(x) for x in fp) for fp in fingerprints]
        levels = [list(cur)]
        for lvl in range(height):
            zero = zh[height - lvl - 1]
            nxt = []
            for i in range(0, len(cur), 2):
                left = cur[i]
                right = cur[i + 1] if i + 1 < len(cur) else \
                    zh[height - lvl]
                nxt.append(tuple(poseidon_host.two_to_one(list(left),
                                                          list(right))))
            if not nxt:
                nxt = [zero]
            cur = nxt
            levels.append(list(cur))
        return cls(height=height, leaves=levels[0], levels=levels)

    @property
    def root(self) -> tuple:
        return self.levels[-1][0]

    def prove(self, index: int) -> MerkleProof:
        """Inclusion proof of leaf `index` (leaf-level siblings first)."""
        zh = zero_hashes(self.height)
        siblings = []
        idx = index
        for lvl in range(self.height):
            sib_idx = idx ^ 1
            level = self.levels[lvl]
            sib = level[sib_idx] if sib_idx < len(level) else \
                zh[self.height - lvl]
            siblings.append(tuple(sib))
            idx >>= 1
        value = self.leaves[index] if index < len(self.leaves) else \
            zh[self.height]
        return MerkleProof(root=self.root, value=tuple(value), index=index,
                           siblings=siblings)

    def index_of(self, fingerprint) -> int:
        return self.leaves.index(tuple(int(x) for x in fingerprint))
