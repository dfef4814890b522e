"""Poseidon Merkle trees with caps over int64 tensors.

Counterpart of the reference's ``core/merkle.py``. Each level is one
batched compress of all its nodes (the sponge kernel on a CUDA tensor). The
cap keeps the top 2^cap_height digests; proofs stop one level below it.
Digests are (num_nodes, 4) tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import convert
from . import cuda_poseidon, poseidon, poseidon_host


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


class MerkleTree:
    """Device-held tree: levels[0] = leaf digests (N, 4); levels[i+1] =
    pairwise compress of levels[i]; stops when 2^cap_height nodes remain
    (the cap)."""

    def __init__(self, leaf_data: torch.Tensor, cap_height: int = 0):
        digests = hash_leaves(leaf_data)
        n = digests.shape[0]
        if n & (n - 1) or n == 0:
            raise ValueError("leaf count must be a power of two")
        if (1 << cap_height) > n:
            raise ValueError("cap is larger than the leaf count")
        self.num_leaves = n
        self.cap_height = cap_height
        levels = [digests]
        d_t = digests.T
        while d_t.shape[1] > (1 << cap_height):
            d_t = cuda_poseidon.reduce_level_t(d_t)
            levels.append(d_t.T)
        self.levels = levels
        self._levels_np = None

    @property
    def cap(self) -> torch.Tensor:
        """(2^cap_height, 4) digests."""
        return self.levels[-1]

    def cap_u64(self) -> np.ndarray:
        return convert.to_u64(self.cap)

    def _host_levels(self) -> list[np.ndarray]:
        """All levels on the host as (n, 4) uint64, fetched once."""
        if self._levels_np is None:
            self._levels_np = [convert.to_u64(lv) for lv in self.levels]
        return self._levels_np

    def prove(self, index: int) -> list[list[int]]:
        """Merkle path for leaf `index`: sibling digests, leaf level first,
        stopping below the cap. Host-side (u64 ints)."""
        siblings = []
        idx = index
        for level in self._host_levels()[:-1]:
            siblings.append([int(x) for x in level[idx ^ 1]])
            idx >>= 1
        return siblings


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
