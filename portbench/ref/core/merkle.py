"""Poseidon Merkle trees with caps over int64 tensors.

Counterpart of the reference's ``core/merkle.py``. Each level is one
batched compress of all its nodes (the plain sponge on any device). The
cap keeps the top 2^cap_height digests; proofs stop one level below it.
Digests are (num_nodes, 4) tensors, or (B, num_nodes, 4) for B trees.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import convert
from . import poseidon, poseidon_host, sponge


def hash_leaves(leaf_data: torch.Tensor) -> torch.Tensor:
    """Hash rows of (num_leaves, k) felt data into (num_leaves, 4) digests.

    Follows plonky2 hash_or_noop: rows with k <= 4 pass through zero-padded,
    otherwise Poseidon sponge.
    """
    k = leaf_data.shape[-1]
    if k <= 4:
        pad = leaf_data.new_zeros(leaf_data.shape[:-1] + (4 - k,))
        return torch.cat([leaf_data, pad], dim=-1)
    return poseidon.hash_no_pad(leaf_data)


class BatchedMerkleTree:
    """B trees built together: leaf data (B, N, k) -> levels of (B, n, 4)
    digests, levels[0] the leaf digests, down to the cap of 2^cap_height
    nodes per tree. Siblings (2j, 2j+1) never cross the end of a tree, so
    a level of the B trees is one level of their leaves laid end to end:
    one sponge launch for all B."""

    def __init__(self, leaf_data: torch.Tensor, cap_height: int = 0):
        digests = hash_leaves(leaf_data)                 # (B, N, 4)
        bsz, n = digests.shape[0], digests.shape[1]
        self._build(digests.reshape(bsz * n, 4).T, bsz, cap_height)

    @classmethod
    def from_polys(cls, polys: torch.Tensor, cap_height: int = 0):
        """B trees over the columns of (B, k, N) polynomial values (leaf j
        of tree b is polys[b, :, j]), as a prover's LDEs are laid out: one
        sponge launch hashes the leaves of all B trees."""
        bsz, k, n = polys.shape
        tree = cls.__new__(cls)
        rows = polys.transpose(0, 1).reshape(k, bsz * n)
        tree._build(sponge.hash_rows_t(rows), bsz, cap_height)
        return tree

    def _build(self, d_t: torch.Tensor, bsz: int, cap_height: int):
        """Levels from the (4, B*N) leaf digests, trees laid end to end."""
        n = d_t.shape[1] // bsz
        if n & (n - 1) or n == 0:
            raise ValueError("leaf count must be a power of two")
        if (1 << cap_height) > n:
            raise ValueError("cap is larger than the leaf count")
        self.batch = bsz
        self.num_leaves = n
        self.cap_height = cap_height
        levels = [d_t.T.reshape(bsz, n, 4)]
        while n > (1 << cap_height):
            d_t = sponge.reduce_level_t(d_t)
            n >>= 1
            levels.append(d_t.T.reshape(bsz, n, 4))
        self.levels = levels
        self._levels_np = None

    @property
    def cap(self) -> torch.Tensor:
        """(B, 2^cap_height, 4)."""
        return self.levels[-1]

    def cap_u64(self, b: int) -> np.ndarray:
        return convert.to_u64(self.cap[b])

    def _host_levels(self) -> list[np.ndarray]:
        """All levels on the host as (B, n, 4) uint64, fetched once."""
        if self._levels_np is None:
            self._levels_np = [convert.to_u64(lv) for lv in self.levels]
        return self._levels_np

    def prove(self, b: int, index: int) -> list[list[int]]:
        """Merkle path for leaf `index` of tree `b`: sibling digests, leaf
        level first, stopping below the cap. Host-side (u64 ints)."""
        siblings = []
        idx = index
        for level in self._host_levels()[:-1]:
            siblings.append([int(x) for x in level[b, idx ^ 1]])
            idx >>= 1
        return siblings


class MerkleTree:
    """One tree, the B = 1 view of BatchedMerkleTree: leaf data (N, k) ->
    levels[0] = leaf digests (N, 4), levels[i+1] = pairwise compress of
    levels[i], down to the cap."""

    def __init__(self, leaf_data: torch.Tensor, cap_height: int = 0):
        self._view(BatchedMerkleTree(leaf_data[None], cap_height))

    @classmethod
    def from_polys(cls, polys: torch.Tensor, cap_height: int = 0):
        """The tree over the columns of (k, N) polynomial values."""
        tree = cls.__new__(cls)
        tree._view(BatchedMerkleTree.from_polys(polys[None], cap_height))
        return tree

    def _view(self, trees: BatchedMerkleTree):
        self._trees = trees
        self.num_leaves = trees.num_leaves
        self.cap_height = trees.cap_height
        self.levels = [lv[0] for lv in trees.levels]

    @property
    def cap(self) -> torch.Tensor:
        """(2^cap_height, 4) digests."""
        return self.levels[-1]

    def cap_u64(self) -> np.ndarray:
        return self._trees.cap_u64(0)

    def prove(self, index: int) -> list[list[int]]:
        """Merkle path for leaf `index`, leaf level first."""
        return self._trees.prove(0, index)


def h_verify_merkle_proof(leaf_digest: list[int], index: int,
                          siblings: list[list[int]],
                          cap: np.ndarray) -> bool:
    """Host-side proof check against a cap (cap: (2^h, 4) uint64)."""
    current = list(leaf_digest)
    idx = index
    for sib in siblings:
        if idx & 1:
            current = poseidon_host.two_to_one(sib, current)
        else:
            current = poseidon_host.two_to_one(current, sib)
        idx >>= 1
    return list(map(int, cap[idx])) == [int(x) for x in current]


def h_hash_leaf(leaf_row: list[int]) -> list[int]:
    return poseidon_host.hash_or_noop(leaf_row)
