"""Batched Poseidon (width 12, rate 8) over Goldilocks int64 tensors.

Counterpart of the reference's ``core/poseidon.py``. The plain permutation
here runs on CPU tensors, in the transposed (12, B) layout that the kernels
of the port use, with the MDS as the reference's ``_mds_layer``
does it: 16-bit limbs times the 12x12 matrix, then one reduction (here two
limbs to an int64 lane).

``permute``, ``two_to_one`` and ``hash_no_pad`` run the plain versions of
``sponge`` on a tensor of any device.
"""

from __future__ import annotations

import numpy as np
import torch

from . import gl64
from . import poseidon_params as params

WIDTH = params.WIDTH
RATE = params.SPONGE_RATE

_RC = np.array(params.ALL_ROUND_CONSTANTS, dtype=np.uint64).reshape(
    params.N_ROUNDS, WIDTH)

# Full MDS matrix (12x12 small ints): row r is circ rotated by r, plus
# diag[r] on the main diagonal.
_MDS = np.zeros((WIDTH, WIDTH), dtype=np.int64)
for _r in range(WIDTH):
    for _i in range(WIDTH):
        _MDS[_r, (_i + _r) % WIDTH] += params.MDS_MATRIX_CIRC[_i]
    _MDS[_r, _r] += params.MDS_MATRIX_DIAG[_r]

_TABLES: dict = {}


def _tables(device):
    """(round constants (30, 12, 1), MDS columns (12, 1, 12, 1)) on device."""
    key = str(device)
    ent = _TABLES.get(key)
    if ent is None:
        rc = torch.from_numpy(_RC.view(np.int64).copy()).to(device)
        mds = torch.from_numpy(_MDS.T.copy()).to(device)   # [i, r]
        ent = (rc.reshape(params.N_ROUNDS, WIDTH, 1),
               mds.reshape(WIDTH, 1, WIDTH, 1))
        _TABLES[key] = ent
    return ent


_LIMBS_0_2 = 0x0000_FFFF_0000_FFFF


def _mds_layer(s: torch.Tensor, mds: torch.Tensor) -> torch.Tensor:
    """Exact MDS multiply on a (12, B) state via 16-bit limbs.

    The limbs go two to an int64 lane: limbs 0 and 2 at bits 0 and 32 of
    one lane, limbs 1 and 3 of the other. Each limb accumulator is
    < 264 * 2^16 < 2^25, so the two fields of a lane never meet; the
    recombined value is < 2^73 and is reduced once."""
    pairs = torch.stack([s & _LIMBS_0_2, (s >> 16) & _LIMBS_0_2])
    acc = mds[0] * pairs[:, 0:1]                  # (2, 12, B)
    for i in range(1, WIDTH):
        acc = acc + mds[i] * pairs[:, i:i + 1]
    a0, a2 = acc[0] & gl64._M32, acc[0] >> 32
    a1, a3 = acc[1] & gl64._M32, acc[1] >> 32
    # recombine the limb sums (bit positions 0, 16, 32, 48)
    t1 = (a0 >> 16) + a1
    t2 = (t1 >> 16) + a2
    t3 = (t2 >> 16) + a3
    lo = ((a0 & 0xFFFF) | ((t1 & 0xFFFF) << 16)
          | ((t2 & 0xFFFF) << 32) | (t3 << 48))
    return gl64._reduce128(lo, t3 >> 16)


def permute_t(s: torch.Tensor) -> torch.Tensor:
    """Plain permutation of a (12, B) state (one state per column)."""
    rc, mds = _tables(s.device)
    h = params.HALF_N_FULL_ROUNDS
    for r in range(params.N_ROUNDS):
        s = gl64.add(s, rc[r])
        if h <= r < h + params.N_PARTIAL_ROUNDS:
            s = torch.cat([gl64.exp7(s[:1]), s[1:]])
        else:
            s = gl64.exp7(s)
        s = _mds_layer(s, mds)
    return s


def permute(state: torch.Tensor) -> torch.Tensor:
    """Poseidon permutation on a state of shape (..., 12)."""
    from . import sponge
    shape = state.shape
    out = sponge.permute_t(state.reshape(-1, WIDTH).T.contiguous())
    return out.T.reshape(shape)


def two_to_one(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """Batched Merkle compress: (..., 4) x (..., 4) -> (..., 4)."""
    from . import sponge
    shape = left.shape
    lt = left.reshape(-1, 4).T
    rt = right.reshape(-1, 4).T
    return sponge.two_to_one_t(lt, rt).T.reshape(shape)


def hash_no_pad(inputs: torch.Tensor) -> torch.Tensor:
    """Batched sponge over (..., n) felt arrays -> (..., 4) digests.

    Hashes for every n, n <= 4 included (unlike merkle.hash_leaves and
    sponge.hash_rows_t, which pass such rows through)."""
    from . import sponge
    n = inputs.shape[-1]
    batch = inputs.shape[:-1]
    xt = inputs.reshape(-1, n).T.contiguous()
    return sponge.sponge_t(xt).T.reshape(batch + (4,))
