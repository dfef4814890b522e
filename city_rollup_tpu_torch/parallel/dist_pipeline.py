"""Fused distributed coset LDE + Merkle-cap commit over a device mesh.

Counterpart of the reference's ``parallel/dist_pipeline.py``: the four-step
coset LDE of one polynomial (two all-to-alls) feeds straight into the local
leaf hashing and cap reduction of ``dist_merkle`` and one all-gather of the
cap. The shape the prover's per-commitment work takes when one large LDE
is split over devices.
"""

from __future__ import annotations

import torch

from ..core import gl64, merkle, ntt
from . import dist_merkle, dist_ntt
from . import mesh as mesh_mod


def dist_lde_commit(mesh, coeffs, log_n: int, rate_bits: int,
                    leaf_width: int, cap_height: int,
                    shift: int = gl64.MULTIPLICATIVE_GROUP_GENERATOR
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Distributed coset LDE of one length-2^log_n polynomial, then a Merkle
    cap over its evaluations grouped ``leaf_width`` consecutive ones a leaf.

    Returns (cap, lde): the (2^cap_height, 4) cap, replicated; this rank's
    contiguous (2^(log_n+rate_bits) / D,) block of the natural-order LDE.
    """
    d = mesh_mod.size(mesh)
    log_m = log_n + rate_bits
    log_r, log_c = dist_ntt._check_split(log_m, d)
    block_len = (1 << log_c) // d << log_r
    if leaf_width < 1 or block_len % leaf_width:
        raise ValueError(f"leaves of {leaf_width} values do not tile a "
                         f"rank's {block_len} evaluations")
    dist_merkle._check_cap((1 << log_m) // leaf_width, cap_height, d)
    x = dist_ntt._on_mesh(mesh, coeffs, (1 << log_n,))
    padded = ntt._coset_scale_pad(x, log_n, rate_bits, shift)
    block = mesh_mod.shard(mesh, padded.reshape(1 << log_r, 1 << log_c),
                           dim=1)
    lde = dist_ntt._dist_ntt_body(mesh, block, dist_ntt._twiddles(mesh, log_m),
                                  log_r, log_c).reshape(-1)
    digests = merkle.hash_leaves(lde.reshape(-1, leaf_width))
    return dist_merkle.replicated_cap(mesh, digests, cap_height), lde
