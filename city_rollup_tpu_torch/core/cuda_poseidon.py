"""Poseidon permutation, sponge and absorb in the transposed layout, with
CUDA kernels.

Counterpart of the reference's ``core/pallas_poseidon.py``: arrays are
(rows, B) int64 tensors in which column j is one sponge input, so the LDE's
(num_polys, M) output hashes all M leaves with no transpose.

``permute_t`` (kernel K3, ``csrc/poseidon.cu`` permute_kernel), ``sponge_t``
(K4, sponge_kernel), ``reduce_level_t`` (K4's Merkle-level entry,
merkle_level_kernel) and ``absorb_t`` (K5, absorb_kernel) launch their
kernels on a CUDA tensor, run their plain PyTorch versions on a CPU tensor,
and count their launches in ``LAUNCHES`` (both K4 entries under
"poseidon_sponge").
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build
from . import poseidon
from . import poseidon_params as params

WIDTH = params.WIDTH
RATE = params.SPONGE_RATE

# Launches of each kernel, counted where the wrapper launches it.
LAUNCHES = {"poseidon_permute": 0, "poseidon_sponge": 0,
            "poseidon_absorb": 0}

# The core's constant tables, in csrc/poseidon.cuh PosTables order: the
# round constants, then for the FP64 MDS 2^52 + each 32-bit word of each
# round's constants (and a last row of 2^52 alone), as float64 bit patterns.
_RC = np.array(params.ALL_ROUND_CONSTANTS, dtype=np.uint64)
_RC_WORDS = np.concatenate([_RC, np.zeros(WIDTH, np.uint64)]).reshape(
    params.N_ROUNDS + 1, WIDTH, 1)
_MDS_START = np.concatenate(
    [_RC_WORDS & np.uint64(0xFFFFFFFF), _RC_WORDS >> np.uint64(32)],
    axis=2).astype(np.float64) + 2.0 ** 52
_TABLES_HOST = np.concatenate([_RC, _MDS_START.view(np.uint64).ravel()])
_INITIALIZED: set = set()


def _lib(t: torch.Tensor):
    """The Poseidon library, with its tables copied to t's device."""
    lib = _build.load("poseidon")
    dev = t.device.index if t.device.index is not None \
        else torch.cuda.current_device()
    if dev not in _INITIALIZED:
        with torch.cuda.device(dev):
            _build.check(lib.city_poseidon_init(_TABLES_HOST.ctypes.data,
                                                _TABLES_HOST.size),
                         "city_poseidon_init")
        _INITIALIZED.add(dev)
    return lib


# ---------------------------------------------------------------------------
# Plain versions of the kernels
# ---------------------------------------------------------------------------

permute_t_plain = poseidon.permute_t


def sponge_t_plain(x_t: torch.Tensor) -> torch.Tensor:
    """Overwrite-mode sponge down each column: (n, B) -> (4, B)."""
    n, b = x_t.shape
    s = x_t.new_zeros((WIDTH, b))
    for start in range(0, n, RATE):
        k = min(RATE, n - start)
        s = torch.cat([x_t[start:start + k], s[k:]])
        s = poseidon.permute_t(s)
    return s[:4]


def reduce_level_t_plain(d_t: torch.Tensor) -> torch.Tensor:
    """One Merkle level: two_to_one of the strided children slices."""
    return sponge_t_plain(torch.cat([d_t[:, 0::2], d_t[:, 1::2]]))


def absorb_t_plain(state_t: torch.Tensor,
                   chunk_t: torch.Tensor) -> torch.Tensor:
    """Overwrite state rows [0, k) with the chunk, then permute."""
    k = chunk_t.shape[0]
    return poseidon.permute_t(torch.cat([chunk_t, state_t[k:]]))


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def permute_t(s_t: torch.Tensor) -> torch.Tensor:
    """K3: permute every column of a (12, B) state."""
    if s_t.dim() != 2 or s_t.shape[0] != WIDTH:
        raise ValueError(f"expected (12, B), got {tuple(s_t.shape)}")
    if not s_t.is_cuda:
        return permute_t_plain(s_t)
    s_t = s_t.contiguous()
    _build.require_cuda("poseidon_permute", s_t)
    lib = _lib(s_t)
    out = torch.empty_like(s_t)
    rc = lib.city_poseidon_permute(s_t.data_ptr(), out.data_ptr(),
                                   s_t.shape[1], _build.stream(s_t))
    _build.check(rc, "city_poseidon_permute")
    LAUNCHES["poseidon_permute"] += 1
    return out


def sponge_t(x_t: torch.Tensor) -> torch.Tensor:
    """K4: sponge-hash every column of (n, B) into a (4, B) digest."""
    if x_t.dim() != 2:
        raise ValueError(f"expected (n, B), got {tuple(x_t.shape)}")
    if not x_t.is_cuda:
        return sponge_t_plain(x_t)
    x_t = x_t.contiguous()
    _build.require_cuda("poseidon_sponge", x_t)
    n, b = x_t.shape
    lib = _lib(x_t)
    out = x_t.new_empty((4, b))
    rc = lib.city_poseidon_sponge(x_t.data_ptr(), out.data_ptr(), n, b,
                                  _build.stream(x_t))
    _build.check(rc, "city_poseidon_sponge")
    LAUNCHES["poseidon_sponge"] += 1
    return out


def absorb_t(state_t: torch.Tensor, chunk_t: torch.Tensor) -> torch.Tensor:
    """K5: state (12, B) x chunk (k <= 8, B) -> permuted state (12, B)."""
    k = chunk_t.shape[0]
    if state_t.dim() != 2 or state_t.shape[0] != WIDTH or \
            chunk_t.dim() != 2 or not 0 < k <= RATE or \
            chunk_t.shape[1] != state_t.shape[1]:
        raise ValueError(f"bad absorb shapes {tuple(state_t.shape)}, "
                         f"{tuple(chunk_t.shape)}")
    if not state_t.is_cuda:
        return absorb_t_plain(state_t, chunk_t)
    state_t, chunk_t = state_t.contiguous(), chunk_t.contiguous()
    _build.require_cuda("poseidon_absorb", state_t, chunk_t)
    lib = _lib(state_t)
    out = torch.empty_like(state_t)
    rc = lib.city_poseidon_absorb(state_t.data_ptr(), chunk_t.data_ptr(),
                                  out.data_ptr(), k, state_t.shape[1],
                                  _build.stream(state_t))
    _build.check(rc, "city_poseidon_absorb")
    LAUNCHES["poseidon_absorb"] += 1
    return out


# ---------------------------------------------------------------------------
# Transposed entry points (twins of pallas_poseidon's)
# ---------------------------------------------------------------------------

def hash_rows_t(leaf_t: torch.Tensor) -> torch.Tensor:
    """Sponge-hash columns: (n, B) -> (4, B) digests.

    Follows plonky2 hash_or_noop: n <= 4 passes through zero-padded."""
    n = leaf_t.shape[0]
    if n <= 4:
        return torch.cat([leaf_t, leaf_t.new_zeros((4 - n,) + leaf_t.shape[1:])])
    return sponge_t(leaf_t)


def two_to_one_t(left_t: torch.Tensor, right_t: torch.Tensor) -> torch.Tensor:
    """Merkle compress, transposed: (4, B) x (4, B) -> (4, B)."""
    return sponge_t(torch.cat([left_t, right_t]))


def reduce_level_t(d_t: torch.Tensor) -> torch.Tensor:
    """K4's Merkle-level entry: (4, 2B) digests -> (4, B) parents, parent j
    the two_to_one of adjacent columns (2j, 2j+1), read in place."""
    if d_t.dim() != 2 or d_t.shape[0] != 4 or d_t.shape[1] % 2:
        raise ValueError(f"expected (4, 2B), got {tuple(d_t.shape)}")
    if not d_t.is_cuda:
        return reduce_level_t_plain(d_t)
    d_t = d_t.contiguous()
    _build.require_cuda("poseidon_sponge", d_t)
    b = d_t.shape[1] // 2
    lib = _lib(d_t)
    out = d_t.new_empty((4, b))
    rc = lib.city_poseidon_merkle_level(d_t.data_ptr(), out.data_ptr(), b,
                                        _build.stream(d_t))
    _build.check(rc, "city_poseidon_merkle_level")
    LAUNCHES["poseidon_sponge"] += 1
    return out
