"""Sharded Merkle-cap commitment over a device mesh.

Counterpart of the reference's ``parallel/dist_merkle.py``. With the leaves
split contiguously over D ranks and 2^cap_height >= D, every sub-cap is
local: each rank hashes its leaves (K4) and reduces them level by level
(K4's Merkle-level entry) to 2^cap_height / D digests with no traffic, and
one all-gather replicates the cap on every rank.
"""

from __future__ import annotations

import torch

from .. import convert
from ..core import cuda_poseidon, merkle
from . import mesh as mesh_mod


def _check_cap(num_leaves: int, cap_height: int, d: int) -> None:
    if (1 << cap_height) < d:
        raise ValueError(f"a cap of 2^{cap_height} digests is smaller than "
                         f"the {d}-device mesh: one digest a device at least")
    if num_leaves & (num_leaves - 1) or num_leaves % d or \
            num_leaves < (1 << cap_height):
        raise ValueError(f"{num_leaves} leaves: not a power of two of at "
                         f"least 2^{cap_height} that {d} devices divide")


def replicated_cap(mesh, digests: torch.Tensor,
                   cap_height: int) -> torch.Tensor:
    """This rank's (L, 4) leaf digests -> the whole (2^cap_height, 4) cap,
    on every rank: local levels down to 2^cap_height / D digests, then one
    all-gather."""
    d = mesh_mod.size(mesh)
    local = 1 << (cap_height - (d.bit_length() - 1))
    d_t = digests.T                                      # (4, L)
    while d_t.shape[1] > local:
        d_t = cuda_poseidon.reduce_level_t(d_t)
    return mesh_mod.gather(mesh, d_t, dim=1).T.contiguous()


def dist_merkle_cap(mesh, leaf_data, cap_height: int) -> torch.Tensor:
    """leaf_data: the global (num_leaves, k) leaf matrix, the same on every
    rank (each hashes its contiguous block of leaves). Returns the
    replicated (2^cap_height, 4) cap, equal to ``merkle.MerkleTree``'s."""
    x = convert.as_tensor(leaf_data, mesh_mod.device(mesh))
    if x.dim() != 2:
        raise ValueError(f"expected (num_leaves, k), got {tuple(x.shape)}")
    _check_cap(x.shape[0], cap_height, mesh_mod.size(mesh))
    return replicated_cap(mesh, merkle.hash_leaves(mesh_mod.shard(mesh, x)),
                          cap_height)
