"""Distributed Goldilocks NTT and coset LDE across a device mesh.

Counterpart of the reference's ``parallel/dist_ntt.py``. Four-step NTT: view
the length ``N = R*C`` coefficient vector as an ``(R, C)`` matrix, give each
of the D ranks a block of C/D columns, then

  1. local column NTTs of length R (``ntt.ntt``: K1/K2 on CUDA);
  2. the twiddle multiply by w^(j2*k1), from this rank's C/D rows of the
     table only;
  3. one ``all_to_all_single`` from column blocks to row blocks;
  4. local row NTTs of length C;
  5. one more ``all_to_all_single`` that leaves the output in natural
     order, a contiguous block of N/D on each rank.

``all_to_all_single`` splits and concatenates along dim 0 only, so before
each exchange the block is laid out (D, ...) with destination s's chunk at
[s], and after it the received (D, ...) chunks, source s's at [s], are laid
back along the axis the reference concatenates on.

Calling convention (SPMD): every rank passes the same global input, an
int64 tensor of u64 bit patterns (or a numpy uint64 array), and gets back
its own block of the natural-order output.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.distributed as dist

from .. import convert
from ..core import gl64, ntt
from . import mesh as mesh_mod


def _split_logs(log_n: int) -> tuple[int, int]:
    """N = R * C with R = 2^ceil(log_n/2) (column NTT), C = 2^floor."""
    log_r = (log_n + 1) // 2
    return log_r, log_n - log_r


@functools.lru_cache(maxsize=None)
def _four_step_twiddles(log_n: int, start: int = 0,
                        stop: int | None = None) -> np.ndarray:
    """Rows [start, stop) of T[j2, k1] = w_N^(j2*k1), shape (C, R), uint64
    (all C rows by default). Columns are filled by doubling: columns
    [k, 2k) are columns [0, k) times (w^j2)^k."""
    log_r, log_c = _split_logs(log_n)
    r, c = 1 << log_r, 1 << log_c
    stop = c if stop is None else stop
    step = gl64.np_powers(gl64.h_primitive_root_of_unity(log_n), stop)[start:]
    t = np.empty((stop - start, r), dtype=np.uint64)
    t[:, 0] = 1
    k = 1
    while k < r:
        t[:, k:2 * k] = gl64.np_mul(t[:, :k], step[:, None])
        step = gl64.np_mul(step, step)
        k *= 2
    return t


def _twiddles(mesh, log_n: int) -> torch.Tensor:
    """This rank's (C/D, R) rows of the table, on its device (cached)."""
    c = 1 << _split_logs(log_n)[1]
    rows = c // mesh_mod.size(mesh)
    start = mesh_mod.rank(mesh) * rows
    return ntt._dev_table(
        ("fourstep_tw", log_n, start, start + rows),
        lambda: _four_step_twiddles(log_n, start, start + rows),
        mesh_mod.device(mesh))


def _check_split(log_n: int, d: int) -> tuple[int, int]:
    log_r, log_c = _split_logs(log_n)
    if (1 << log_r) % d or (1 << log_c) % d:
        raise ValueError(f"a 2^{log_n} transform splits into R = 2^{log_r} "
                         f"x C = 2^{log_c}, which {d} devices do not divide")
    return log_r, log_c


def _on_mesh(mesh, x, shape: tuple) -> torch.Tensor:
    """x as an int64 tensor of the given shape on this rank's device."""
    t = convert.as_tensor(x, mesh_mod.device(mesh))
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    return t


def _exchange(mesh, x: torch.Tensor) -> torch.Tensor:
    """(D, ...) chunks, chunk s to rank s -> (D, ...), chunk s from rank s."""
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=mesh_mod.group(mesh))
    return out


def _dist_ntt_body(mesh, block: torch.Tensor, tw: torch.Tensor,
                   log_r: int, log_c: int) -> torch.Tensor:
    """This rank's (R, C/D) column block -> its (C/D, R) natural-order block
    (rows k2, columns k1: flattened, X[k] at k = k2*R + k1)."""
    d = mesh_mod.size(mesh)
    r, c = 1 << log_r, 1 << log_c
    # 1. column NTTs (length R): the transform axis last
    y = ntt.ntt(block.T.contiguous(), log_r)             # [j2_loc, k1]
    # 2. twiddles T[j2, k1], this rank's rows
    y = gl64.mul(y, tw)
    # 3. column blocks -> row blocks: k1 block s goes to rank s; rank s's
    # j2 block comes back at [s]
    y = _exchange(mesh, y.reshape(c // d, d, r // d).transpose(0, 1))
    y = y.reshape(c, r // d).T.contiguous()               # [k1_loc, j2]
    # 4. row NTTs (length C)
    y = ntt.ntt(y, log_c)                                 # [k1_loc, k2]
    # 5. natural order: k2 block s goes to rank s; rank s's k1 block comes
    # back at [s] and is laid along the columns
    y = _exchange(mesh, y.T.reshape(d, c // d, r // d))   # [s, k2_loc, k1_loc]
    return y.transpose(0, 1).reshape(c // d, r)


def dist_ntt(mesh, coeffs, log_n: int) -> torch.Tensor:
    """Distributed forward NTT of one length-2^log_n polynomial: coeffs
    (N,) -> this rank's contiguous (N/D,) block of the natural-order
    evaluations."""
    log_r, log_c = _check_split(log_n, mesh_mod.size(mesh))
    x = _on_mesh(mesh, coeffs, (1 << log_n,))
    block = mesh_mod.shard(mesh, x.reshape(1 << log_r, 1 << log_c), dim=1)
    return _dist_ntt_body(mesh, block, _twiddles(mesh, log_n),
                          log_r, log_c).reshape(-1)


def dist_coset_lde(mesh, coeffs, log_n: int, rate_bits: int,
                   shift: int = gl64.MULTIPLICATIVE_GROUP_GENERATOR
                   ) -> torch.Tensor:
    """Distributed coset LDE: (N,) coeffs -> this rank's block of the
    (N * 2^rate_bits,) natural-order evaluations on shift * <w>."""
    x = _on_mesh(mesh, coeffs, (1 << log_n,))
    return dist_ntt(mesh, ntt._coset_scale_pad(x, log_n, rate_bits, shift),
                    log_n + rate_bits)


def dist_batched_coset_lde(mesh, coeffs, log_n: int, rate_bits: int,
                           shift: int = gl64.MULTIPLICATIVE_GROUP_GENERATOR
                           ) -> torch.Tensor:
    """Batched coset LDE with the POLY axis sharded (pure data parallelism,
    no traffic): coeffs (B, 2^log_n), B a multiple of the mesh size ->
    this rank's (B/D, 2^(log_n+rate_bits)) block, from the single-device
    ``ntt.coset_lde`` on its slice."""
    x = convert.as_tensor(coeffs, mesh_mod.device(mesh))
    if x.dim() != 2 or x.shape[1] != 1 << log_n:
        raise ValueError(f"expected (B, {1 << log_n}), got {tuple(x.shape)}")
    if x.shape[0] % mesh_mod.size(mesh):
        raise ValueError(f"a poly batch of {x.shape[0]} does not divide the "
                         f"{mesh_mod.size(mesh)}-device mesh")
    return ntt.coset_lde(mesh_mod.shard(mesh, x), log_n, rate_bits, shift)
