"""Plain Poseidon sponge entries in the transposed (rows, B) layout.

The frozen copy's stand-in for the port's kernel wrappers: the same entry
names (``permute_t``, ``sponge_t``, ``hash_rows_t``, ``two_to_one_t``,
``reduce_level_t``, ``absorb_t``), each the plain PyTorch version that the
port keeps beside its kernel, on a tensor of any device.
"""

from __future__ import annotations

import torch

from . import poseidon
from . import poseidon_params as params

WIDTH = params.WIDTH
RATE = params.SPONGE_RATE

permute_t = poseidon.permute_t


def sponge_t(x_t: torch.Tensor) -> torch.Tensor:
    """Overwrite-mode sponge down each column: (n, B) -> (4, B)."""
    n, b = x_t.shape
    s = x_t.new_zeros((WIDTH, b))
    for start in range(0, n, RATE):
        k = min(RATE, n - start)
        s = torch.cat([x_t[start:start + k], s[k:]])
        s = poseidon.permute_t(s)
    return s[:4]


def hash_rows_t(leaf_t: torch.Tensor) -> torch.Tensor:
    """Sponge-hash columns: (n, B) -> (4, B) digests; n <= 4 passes
    through zero-padded (plonky2 hash_or_noop)."""
    n = leaf_t.shape[0]
    if n <= 4:
        return torch.cat([leaf_t,
                          leaf_t.new_zeros((4 - n,) + leaf_t.shape[1:])])
    return sponge_t(leaf_t)


def two_to_one_t(left_t: torch.Tensor, right_t: torch.Tensor) -> torch.Tensor:
    return sponge_t(torch.cat([left_t, right_t]))


def reduce_level_t(d_t: torch.Tensor) -> torch.Tensor:
    """One Merkle level: parent j is two_to_one of columns (2j, 2j+1)."""
    return sponge_t(torch.cat([d_t[:, 0::2], d_t[:, 1::2]]))


def absorb_t(state_t: torch.Tensor, chunk_t: torch.Tensor) -> torch.Tensor:
    """Overwrite state rows [0, k) with the chunk, then permute."""
    k = chunk_t.shape[0]
    return poseidon.permute_t(torch.cat([chunk_t, state_t[k:]]))
