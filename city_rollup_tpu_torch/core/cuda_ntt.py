"""Four-step NTT / coset LDE over Goldilocks with hand-written CUDA kernels.

Counterpart of the reference's ``core/pallas_ntt.py``. A length-N transform
(N = n2 * n1) runs as:

  1. one gather: the (n2, n1) matrix view with its n2 axis bit-reversed,
     laid out so that every length-n2 transform is one contiguous row;
  2. kernel K1 (``csrc/ntt.cu``, ntt_block_kernel<true>): all log2(n2)
     butterfly stages of each row in shared memory, then value k2 of the
     row for column c multiplied by w_N^(c * k2);
  3. one gather: the transpose, bit-reversed along n1, again one row per
     transform;
  4. kernel K2 (ntt_block_kernel<false>): the first min(log2(n1),
     MAX_KERNEL_LOG) stages per contiguous 2^ks segment, then one
     ``_tail_stage`` kernel pass for each stage left;
  5. one transpose back to natural order.

The reference lays each transform down the TPU's sublanes instead, (m, L)
with the lanes across; here ``_small_ntt`` and ``_tail_stage`` take (L, m),
one transform per row, which is what lets a GPU block read its segment with
coalesced loads (see the note in ``csrc/ntt.cu``).

Every kernel wrapper launches its kernel on a CUDA tensor (or raises), runs
its plain PyTorch version on a CPU tensor, and counts its launches in
``LAUNCHES``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import _build
from . import gl64
from . import ntt as tntt

# Stages run inside one block-kernel launch: a 2^12-value segment is 32 KB
# of shared memory. Longer transforms finish with _tail_stage passes. A
# test may lower it to reach the tail stages at small sizes.
MAX_KERNEL_LOG = 12

# Launches of each kernel, counted where the wrapper launches it.
LAUNCHES = {"ntt_fourstep_tw": 0, "ntt_block": 0, "ntt_tail_stage": 0}


# ---------------------------------------------------------------------------
# Host tables (cached; copied to each device once through ntt._dev_table)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _stage_twiddle_cols(log_m: int, inverse: bool) -> np.ndarray:
    """(log_m * m,) uint64: rows [s*m + i] = w^((i & (2^s-1)) * m >> (s+1)),
    the per-row butterfly twiddle for stage s in the rolled formulation."""
    m = 1 << log_m
    w = gl64.h_primitive_root_of_unity(log_m)
    if inverse:
        w = gl64.h_inverse(w)
    pw = gl64.np_powers(w, max(m // 2, 1))
    idx = np.arange(m)
    out = np.empty(log_m * m, dtype=np.uint64)
    for s in range(log_m):
        h = 1 << s
        stride = m >> (s + 1)
        out[s * m:(s + 1) * m] = pw[(idx & (h - 1)) * stride]
    return out


@functools.lru_cache(maxsize=None)
def _gcol(log_n: int, log_n2: int, b: int, lanes_padded: int,
          inverse: bool) -> np.ndarray:
    """(lanes_padded,) uint64 four-step twiddle seeds: lane r (= bb*n1 + c)
    carries g = w_N^c; the kernel raises it to k2 along the transform."""
    n1 = 1 << (log_n - log_n2)
    w = gl64.h_primitive_root_of_unity(log_n)
    if inverse:
        w = gl64.h_inverse(w)
    pw = gl64.np_powers(w, n1)
    out = np.zeros(lanes_padded, dtype=np.uint64)
    out[:b * n1] = np.tile(pw, b)
    return out


def _stage_table(log_m: int, inverse: bool, device) -> torch.Tensor:
    return tntt._dev_table(("stw", log_m, inverse),
                           lambda: _stage_twiddle_cols(log_m, inverse),
                           device)


def _split(log_n: int) -> int:
    """log_n2 (first-kernel transform size). Balanced, but capped at
    MAX_KERNEL_LOG: the four-step twiddle runs inside kernel 1, so that
    transform must fit a single block; kernel 2 spills its cross-block
    stages to _tail_stage passes instead."""
    return min(log_n // 2, MAX_KERNEL_LOG)


# ---------------------------------------------------------------------------
# Plain versions of the kernels (CPU tensors; compared with the kernels on
# the card)
# ---------------------------------------------------------------------------

def _block_stages_plain(x: torch.Tensor, tw: torch.Tensor, g, ks: int):
    """Plain version of ntt_block_kernel: x (R, m), m a multiple of 2^ks,
    its values bit-reversed per 2^ks segment. Runs the ks DIT stages of
    every segment; with g (R,), also multiplies value k of row r by
    g[r]^k (then m must be 2^ks)."""
    mk = 1 << ks
    rows = x.shape[0]
    segs = x.reshape(-1, mk)
    for s in range(ks):
        half = 1 << s
        v = segs.reshape(segs.shape[0], mk // (2 * half), 2, half)
        even, odd = v[:, :, 0, :], v[:, :, 1, :]
        t = gl64.mul(odd, tw[s * mk:s * mk + half])
        segs = torch.stack([gl64.add(even, t), gl64.sub(even, t)], dim=2)
        segs = segs.reshape(-1, mk)
    y = segs.reshape(x.shape)
    if g is None:
        return y
    # binary exponentiation over the bits of k, as the reference builds it
    k = torch.arange(mk, device=x.device)
    pw = torch.ones_like(y)
    gp = g.reshape(rows, 1)
    for t in range(ks):
        bit = ((k >> t) & 1) == 1
        pw = torch.where(bit, gl64.mul(pw, gp), pw)
        gp = gl64.mul(gp, gp)
    return gl64.mul(y, pw)


def _tail_stage_plain(x: torch.Tensor, s: int, log_m: int,
                      tt: torch.Tensor) -> torch.Tensor:
    """Plain version of ntt_tail_kernel: DIT stage s across rows of 2^log_m."""
    m = 1 << log_m
    half = 1 << s
    v = x.reshape(x.shape[0], m // (2 * half), 2, half)
    even, odd = v[:, :, 0, :], v[:, :, 1, :]
    t = gl64.mul(odd, tt[s * m:s * m + half])
    return torch.stack([gl64.add(even, t), gl64.sub(even, t)],
                       dim=2).reshape(x.shape)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _block_stages(x: torch.Tensor, tw: torch.Tensor, g, ks: int):
    """K1 (with g) or K2 (without): see _block_stages_plain."""
    mk = 1 << ks
    if x.dim() != 2 or x.shape[1] % mk:
        raise ValueError(f"rows of {tuple(x.shape)} are not 2^{ks} segments")
    if tw.numel() != ks * mk:
        raise ValueError("stage twiddle table has the wrong size")
    if g is not None and (x.shape[1] != mk or g.numel() != x.shape[0]):
        raise ValueError("four-step seeds need one 2^ks row per seed")
    if not x.is_cuda:
        return _block_stages_plain(x, tw, g, ks)
    tensors = (x, tw) if g is None else (x, tw, g)
    _build.require_cuda("ntt_block", *tensors)
    lib = _build.load("ntt")
    out = torch.empty_like(x)
    rc = lib.city_ntt_block(x.data_ptr(), out.data_ptr(), tw.data_ptr(),
                            None if g is None else g.data_ptr(),
                            x.numel() >> ks, ks, _build.stream(x))
    _build.check(rc, "city_ntt_block")
    LAUNCHES["ntt_block" if g is None else "ntt_fourstep_tw"] += 1
    return out


def _tail_stage(x: torch.Tensor, s: int, log_m: int,
                tt: torch.Tensor) -> torch.Tensor:
    """One cross-block DIT butterfly stage (rows of 2^log_m, stage s), for
    the stages past MAX_KERNEL_LOG that one block cannot hold. tt: the
    full-length (log_m * m) stage-twiddle table."""
    if x.dim() != 2 or x.shape[1] != 1 << log_m or not 0 <= s < log_m:
        raise ValueError(f"bad tail stage {s} of 2^{log_m} on {x.shape}")
    if tt.numel() != log_m << log_m:
        raise ValueError("tail twiddle table has the wrong size")
    if not x.is_cuda:
        return _tail_stage_plain(x, s, log_m, tt)
    _build.require_cuda("ntt_tail", x, tt)
    lib = _build.load("ntt")
    out = torch.empty_like(x)
    rc = lib.city_ntt_tail(x.data_ptr(), out.data_ptr(), tt.data_ptr(),
                           x.shape[0], log_m, s, _build.stream(x))
    _build.check(rc, "city_ntt_tail")
    LAUNCHES["ntt_tail_stage"] += 1
    return out


def _small_ntt(x: torch.Tensor, tw: torch.Tensor, g, log_m: int,
               tt=None) -> torch.Tensor:
    """(L, m) -> (L, m): one length-m transform per row, input rows in
    bit-reversed order. g (L,) enables the four-step twiddle (then
    log_m <= MAX_KERNEL_LOG); None for the plain second transform.

    The block kernel runs the first ks = min(log_m, MAX_KERNEL_LOG) stages
    (tw: the length-2^ks stage table); the cross-block stages left run as
    _tail_stage passes (tt: the full-length table)."""
    ks = min(log_m, MAX_KERNEL_LOG)
    if g is not None and log_m > MAX_KERNEL_LOG:
        raise ValueError("the four-step twiddle needs log_m <= "
                         "MAX_KERNEL_LOG")
    y = _block_stages(x, tw, g, ks)
    for s in range(ks, log_m):
        y = _tail_stage(y, s, log_m, tt)
    return y


# ---------------------------------------------------------------------------
# Four-step orchestration
# ---------------------------------------------------------------------------

def _fourstep(x: torch.Tensor, log_n: int, inverse: bool) -> torch.Tensor:
    """(b, n) -> (b, n) NTT (inverse: with w^-1, unscaled)."""
    b = x.shape[0]
    n = 1 << log_n
    log_n2 = _split(log_n)
    log_n1 = log_n - log_n2
    n2, n1 = 1 << log_n2, 1 << log_n1
    log_k1 = min(log_n1, MAX_KERNEL_LOG)
    dev = x.device
    tw2 = _stage_table(log_n2, inverse, dev)
    tw1 = _stage_table(log_k1, inverse, dev)
    tt1 = _stage_table(log_n1, inverse, dev) if log_n1 > log_k1 else None
    g = tntt._dev_table(("pg", log_n, log_n2, b, inverse),
                        lambda: _gcol(log_n, log_n2, b, b * n1, inverse),
                        dev)
    # step 1: row bb*n1 + c holds x[bb, brev2[i]*n1 + c] at column i
    a = x.reshape(b, n2, n1).transpose(1, 2)
    a = a.index_select(2, tntt._perm(log_n2, dev)).reshape(b * n1, n2)
    # step 2: length-n2 transforms + four-step twiddle w_N^(c * k2)
    y = _small_ntt(a, tw2, g, log_n2)
    # step 3: row bb*n2 + k2 holds y[bb*n1 + brev1[i], k2] at column i
    bt = y.reshape(b, n1, n2).transpose(1, 2)
    bt = bt.index_select(2, tntt._perm(log_n1, dev)).reshape(b * n2, n1)
    # step 4: length-n1 transforms
    c = _small_ntt(bt, tw1, None, log_n1, tt1)
    # step 5: out[bb, k1*n2 + k2] = c[bb*n2 + k2, k1]
    return c.reshape(b, n2, n1).transpose(1, 2).reshape(b, n)


def _run(x: torch.Tensor, log_n: int, inverse: bool) -> torch.Tensor:
    n = 1 << log_n
    if x.shape[-1] != n:
        raise ValueError(f"last axis is {x.shape[-1]}, expected {n}")
    shape = x.shape
    return _fourstep(x.reshape(-1, n), log_n, inverse).reshape(shape)


# ---------------------------------------------------------------------------
# Public entry points (twins of core/ntt.py)
# ---------------------------------------------------------------------------

def ntt(x: torch.Tensor, log_n: int) -> torch.Tensor:
    return _run(x, log_n, inverse=False)


def intt(x: torch.Tensor, log_n: int) -> torch.Tensor:
    return tntt._scale_const(_run(x, log_n, inverse=True),
                             gl64.h_inverse(1 << log_n))


def coset_lde(coeffs: torch.Tensor, log_n: int, rate_bits: int,
              shift: int = gl64.MULTIPLICATIVE_GROUP_GENERATOR
              ) -> torch.Tensor:
    """coeffs (..., 2^log_n) -> evals (..., 2^(log_n+rate_bits)) on the
    coset shift*<w> — the commit's hot path."""
    padded = tntt._coset_scale_pad(coeffs, log_n, rate_bits, shift)
    return ntt(padded, log_n + rate_bits)


def coset_intt(evals: torch.Tensor, log_m: int,
               shift: int = gl64.MULTIPLICATIVE_GROUP_GENERATOR
               ) -> torch.Tensor:
    inv_shift = gl64.h_inverse(shift % gl64.P)
    c = intt(evals, log_m)
    return gl64.mul(c, tntt._coset_table(log_m, inv_shift, evals.device))
