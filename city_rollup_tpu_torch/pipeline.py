"""Batched coset-LDE + Merkle-cap commitment: the prover's hot path.

Counterpart of the reference's ``pipeline.py``. Both commits take the
transposed route of the reference: the LDE's (num_polys, M) output is
already column-per-leaf, so the sponge kernel hashes all M leaves with no
transpose, and each tree level is one sponge launch over (8, width/2). For
num_polys <= 4 the leaves pass through zero-padded (hash_or_noop). The cap
equals the reference's on either of its routes.

Both entry points run on CUDA unless ``device="cpu"`` is given.
"""

from __future__ import annotations

import torch

from . import convert
from .core import cuda_poseidon, ntt


def _cap_from_digests(d_t: torch.Tensor, cap_height: int) -> torch.Tensor:
    """(4, M) leaf digests -> (2^cap_height, 4) cap."""
    while d_t.shape[-1] > (1 << cap_height):
        d_t = cuda_poseidon.reduce_level_t(d_t)
    return d_t.T.contiguous()


def lde_commit(coeffs, *, log_n: int, rate_bits: int, cap_height: int,
               device=None) -> torch.Tensor:
    """coeffs (B, 2^log_n) -> Merkle cap (2^cap_height, 4) over the LDE rows.

    coeffs: an int64 tensor or a numpy uint64 array."""
    x = convert.as_tensor(coeffs, device)
    lde = ntt.coset_lde(x, log_n, rate_bits)          # (B, M)
    d_t = cuda_poseidon.hash_rows_t(lde)              # (4, M)
    del lde
    return _cap_from_digests(d_t, cap_height)


def lde_commit_streamed(coeffs, *, log_n: int, rate_bits: int,
                        cap_height: int, chunk: int = 8,
                        device=None) -> torch.Tensor:
    """Memory-lean commit: ``chunk`` (<= sponge rate) polynomials at a time
    are LDE'd and absorbed into a resident (12, M) sponge state — one
    Poseidon absorb per slab, the plonky2 leaf-hash schedule — so no more
    than one slab's LDE is held at once."""
    x = convert.as_tensor(coeffs, device)
    b = x.shape[0]
    if b % chunk or not 0 < chunk <= cuda_poseidon.RATE:
        raise ValueError(f"{b} polynomials do not split into slabs of "
                         f"{chunk} <= {cuda_poseidon.RATE}")
    m = 1 << (log_n + rate_bits)
    state = x.new_zeros((cuda_poseidon.WIDTH, m))
    for c in range(0, b, chunk):
        slab = ntt.coset_lde(x[c:c + chunk], log_n, rate_bits)
        state = cuda_poseidon.absorb_t(state, slab)
        del slab
    return _cap_from_digests(state[:4], cap_height)
