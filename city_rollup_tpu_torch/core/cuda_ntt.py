"""Four-step NTT / coset LDE over Goldilocks with hand-written CUDA kernels.

Counterpart of the reference's ``core/pallas_ntt.py``. A length-N transform
(N = n2 * n1) is the (n2, n1) matrix x[a * n1 + c]:

  1. kernel K1 (``csrc/ntt.cu``, ntt_block_kernel<true>): for each column c
     the length-n2 DFT over a, times w_N^(c * k2), stored tiled (``_tile``).
     It reads the input rows as they are: an LDE's coefficients, scaled by
     shift^j on the way in, with the zero padding never read or written;
  2. kernel K2 (ntt_block_kernel<false>): for each row k2 the length-n1 DFT
     over c, stored at X[k1 * n2 + k2] in natural order, or at -k mod N for
     an inverse transform, times n^-1 (and shift^-k for a coset).

The reference gathers, bit-reverses and transposes around its two kernels,
and scales and pads in jnp; here the kernels do all of it, so an LDE makes
one intermediate and one output (see the note in ``csrc/ntt.cu``).

A K2 row longer than 2^MAX_KERNEL_LOG runs as segments: K2 writes the first
stages of a DIT transform per segment in row layout, one ``_tail_stage``
kernel pass runs each stage left, and a torch transpose restores natural
order. No commit or FRI size needs it (2^25 = 2^13 x 2^12 is the largest).

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

# Log length of the longest transform a block runs, K1's columns and K2's
# rows (or segments of a longer row): two transforms of 2^13 values fill
# 128 KB of shared memory. A test may lower it to reach the tail stages at
# small sizes.
MAX_KERNEL_LOG = 13
# The radix-16 twiddles in csrc/ntt.cu are powers of 2: w_16 = 2^W16_LOG2
# (its kW16Log2).
W16_LOG2 = 156

# Launches of each kernel, counted where the wrapper launches it.
LAUNCHES = {"ntt_fourstep_tw": 0, "ntt_block": 0, "ntt_tail_stage": 0}


# ---------------------------------------------------------------------------
# Host tables (cached; copied to each device once through ntt._dev_table)
# ---------------------------------------------------------------------------

def _root(log_m: int) -> int:
    return gl64.h_primitive_root_of_unity(log_m)


@functools.lru_cache(maxsize=None)
def _pow_cols(log_m: int) -> np.ndarray:
    """(m,) uint64: w_m^e for e < m, the twiddles between a block's
    passes (w_L^(a k) = w_m^(a k m / L))."""
    return gl64.np_powers(_root(log_m), 1 << log_m)


def _tw_split(log_n: int) -> int:
    return (log_n + 1) // 2


@functools.lru_cache(maxsize=None)
def _tw_cols(log_n: int) -> np.ndarray:
    """w_N^e as two tables, w_N^e = T[e & (2^h - 1)] * T[2^h + (e >> h)]:
    K1's four-step twiddles w_N^(c k2)."""
    h = _tw_split(log_n)
    w = _root(log_n)
    return np.concatenate([gl64.np_powers(w, 1 << h),
                           gl64.np_powers(gl64.h_exp(w, 1 << h),
                                          1 << (log_n - h))])


@functools.lru_cache(maxsize=None)
def _stage_twiddle_cols(log_m: int, inverse: bool) -> np.ndarray:
    """(log_m * m,) uint64: rows [s*m + i] = w^((i & (2^s-1)) * m >> (s+1)),
    the per-row butterfly twiddle for stage s in the rolled formulation."""
    m = 1 << log_m
    w = _root(log_m)
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
def _out_scale(log_n: int, shift) -> np.ndarray:
    """An inverse transform's output factors: n^-1, times shift^-k at
    output k for a coset (shift not None)."""
    n_inv = gl64.h_inverse(1 << log_n)
    if shift is None:
        return np.array([n_inv], dtype=np.uint64)
    pw = gl64.np_powers(gl64.h_inverse(shift % gl64.P), 1 << log_n)
    return gl64.np_mul(pw, np.uint64(n_inv))


def _table(name: str, fn, *args, device) -> torch.Tensor:
    return tntt._dev_table((name,) + args, lambda: fn(*args), device)


def _stage_table(log_m: int, device) -> torch.Tensor:
    return _table("stw", _stage_twiddle_cols, log_m, False, device=device)


@functools.lru_cache(maxsize=None)
def _check_w16() -> None:
    if pow(2, W16_LOG2, gl64.P) != _root(4):
        raise AssertionError("w_16 is not 2^W16_LOG2: csrc/ntt.cu's radix-16 "
                             "twiddles do not match this root")


def _split(log_n: int) -> int:
    """log_n2 (K1's transform size): the larger half, capped at
    MAX_KERNEL_LOG. K1 reads only an LDE's 2^-rate_bits nonzero rows, so it
    takes the longer transforms (2^25 = 2^13 x 2^12), and K2, which writes
    every value with a stride, the shorter ones in more columns a block."""
    return min(log_n - log_n // 2, MAX_KERNEL_LOG)


def _segment_log(log_n1: int) -> int:
    """Log length of K2's segments of a row of 2^log_n1."""
    return min(log_n1, MAX_KERNEL_LOG)


def _launch_shape(log_m: int, max_log_cols: int) -> tuple[int, int]:
    """(log_cols, threads) of a K1 or K2 block running transforms of
    2^log_m: up to 4 neighbouring transforms in at most 128 KB of shared
    memory, and 512 threads where that leaves room for one block an SM,
    else 256 (the fastest on the card, PERF.md)."""
    log_cols = max(0, min(2, max_log_cols, 14 - log_m))
    return log_cols, 512 if log_m + log_cols == 14 else 256


def _tile_log(log_n2: int) -> int:
    return min(log_n2, 2)


# ---------------------------------------------------------------------------
# Plain versions of the kernels (CPU tensors; compared with the kernels on
# the card)
# ---------------------------------------------------------------------------

def _tile(y: torch.Tensor, log_n2: int) -> torch.Tensor:
    """(b, n1, n2) Y[c, k2] -> (b, N) tiled: ((k2 / T) n1 + c) T + k2 % T."""
    b, n1, n2 = y.shape
    t = 1 << _tile_log(log_n2)
    return y.reshape(b, n1, n2 // t, t).permute(0, 2, 1, 3).reshape(b, -1)


def _untile(y: torch.Tensor, log_n: int, log_n2: int) -> torch.Tensor:
    """(b, N) tiled -> (b, n2, n1) rows Y[k2, :]."""
    n2, n1 = 1 << log_n2, 1 << (log_n - log_n2)
    t = 1 << _tile_log(log_n2)
    return y.reshape(-1, n2 // t, n1, t).permute(0, 1, 3, 2).reshape(
        -1, n2, n1)


def _tw_pow_plain(e: torch.Tensor, log_n: int) -> torch.Tensor:
    h = _tw_split(log_n)
    tw = _table("tw", _tw_cols, log_n, device=e.device)
    return gl64.mul(tw[e & ((1 << h) - 1)], tw[(1 << h) + (e >> h)])


def _dft_rows(x: torch.Tensor, log_m: int) -> torch.Tensor:
    return tntt._ntt_core(x, tntt._root_table(log_m, False, x.device), log_m)


def _k1_plain(x: torch.Tensor, log_n: int, log_n2: int,
              pre=None) -> torch.Tensor:
    """Plain version of K1: x (b, n_in), n_in <= N = 2^log_n, the first
    n_in values of each length-N row (the rest zero), times pre (n_in,)
    if given. Returns Y[k2, c] = w_N^(c k2) * sum_a x[a n1 + c] w_n2^(a k2),
    tiled (b, N)."""
    b, n_in = x.shape
    n2, n1 = 1 << log_n2, 1 << (log_n - log_n2)
    if pre is not None:
        x = gl64.mul(x, pre)
    full = x.new_zeros((b, n2 * n1))
    full[:, :n_in] = x
    cols = full.reshape(b, n2, n1).transpose(1, 2).reshape(b * n1, n2)
    y = _dft_rows(cols, log_n2).reshape(b, n1, n2)
    e = (torch.arange(n1, device=x.device).reshape(n1, 1) *
         torch.arange(n2, device=x.device).reshape(1, n2))
    return _tile(gl64.mul(y, _tw_pow_plain(e, log_n)), log_n2)


def _k2_plain(y: torch.Tensor, log_n: int, log_n2: int, log_t: int = 0,
              reverse: bool = False, scale=None) -> torch.Tensor:
    """Plain version of K2 on K1's tiled (b, N) output. log_t = 0: the
    length-n1 DFT of every row k2, X[k1 n2 + k2] (b, N), at -k mod N if
    reverse, times scale[k] (scale of length N, or 1 for a constant).
    log_t > 0: (b n2, n1) rows, position s 2^seg + k' holding the DFT over u
    of Y[k2, brev_t(s) + 2^t u] (seg = log_n1 - log_t)."""
    n = 1 << log_n
    n2, log_n1 = 1 << log_n2, log_n - log_n2
    rows = _untile(y, log_n, log_n2).reshape(-1, 1 << log_n1)
    if log_t:
        seg = log_n1 - log_t
        sub = rows.reshape(-1, 1 << seg, 1 << log_t).transpose(1, 2)
        sub = sub.index_select(1, tntt._perm(log_t, y.device))
        return _dft_rows(sub.reshape(-1, 1 << seg), seg).reshape(rows.shape)
    x = _dft_rows(rows, log_n1).reshape(-1, n2, 1 << log_n1)
    x = x.transpose(1, 2).reshape(-1, n)
    if reverse:
        x = x.index_select(1, (-torch.arange(n, device=y.device)) % n)
    if scale is not None:
        x = gl64.mul(x, scale.expand(n) if scale.numel() == 1 else scale)
    return x


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

def _k1(x: torch.Tensor, log_n: int, log_n2: int, pre=None) -> torch.Tensor:
    """K1: see _k1_plain."""
    if x.dim() != 2:
        raise ValueError(f"K1 takes (b, n_in), not {tuple(x.shape)}")
    b, n_in = x.shape
    log_n1 = log_n - log_n2
    if not 0 <= log_n2 <= MAX_KERNEL_LOG or log_n1 < 0 or \
            n_in & (n_in - 1) or not 0 < n_in <= 1 << log_n:
        raise ValueError(f"K1: bad shape {tuple(x.shape)} for 2^{log_n2} x "
                         f"2^{log_n1}")
    if pre is not None and pre.numel() != n_in:
        raise ValueError("K1: pre needs one factor per input value")
    if not x.is_cuda:
        return _k1_plain(x, log_n, log_n2, pre)
    _check_w16()
    dev = x.device
    pw = _table("pw", _pow_cols, log_n2, device=dev)
    tw = _table("tw", _tw_cols, log_n, device=dev)
    tensors = (x, pw, tw) if pre is None else (x, pw, tw, pre)
    _build.require_cuda("ntt_k1", *tensors)
    lib = _build.load("ntt")
    out = torch.empty((b, 1 << log_n), dtype=torch.int64, device=dev)
    log_cols, threads = _launch_shape(log_n2, log_n1)
    rc = lib.city_ntt_k1(x.data_ptr(), out.data_ptr(), pw.data_ptr(),
                         tw.data_ptr(), None if pre is None else
                         pre.data_ptr(), n_in, b, log_n2, log_n1,
                         _tw_split(log_n), log_cols, threads,
                         _build.stream(x))
    _build.check(rc, "city_ntt_k1")
    LAUNCHES["ntt_fourstep_tw"] += 1
    return out


def _k2(y: torch.Tensor, log_n: int, log_n2: int, log_t: int = 0,
        reverse: bool = False, scale=None) -> torch.Tensor:
    """K2: see _k2_plain."""
    n = 1 << log_n
    log_n1 = log_n - log_n2
    if y.dim() != 2 or y.shape[1] != n or not 0 <= log_t < max(log_n1, 1):
        raise ValueError(f"K2: bad shape {tuple(y.shape)} for 2^{log_n}")
    if log_t and (reverse or scale is not None):
        raise ValueError("K2: a segmented transform is scaled after its "
                         "tail stages")
    if scale is not None and scale.numel() not in (1, n):
        raise ValueError("K2: scale needs 1 or N factors")
    if not y.is_cuda:
        return _k2_plain(y, log_n, log_n2, log_t, reverse, scale)
    _check_w16()
    dev = y.device
    pw = _table("pw", _pow_cols, log_n1 - log_t, device=dev)
    tensors = (y, pw) if scale is None else (y, pw, scale)
    _build.require_cuda("ntt_k2", *tensors)
    lib = _build.load("ntt")
    out = torch.empty_like(y)
    log_cols, threads = _launch_shape(log_n1 - log_t, _tile_log(log_n2))
    rc = lib.city_ntt_k2(y.data_ptr(), out.data_ptr(), pw.data_ptr(),
                         None if scale is None else scale.data_ptr(),
                         0 if scale is None else scale.numel() - 1,
                         y.shape[0], log_n2, log_n1, log_t, int(reverse),
                         log_cols, threads, _build.stream(y))
    _build.check(rc, "city_ntt_k2")
    LAUNCHES["ntt_block"] += 1
    return out if not log_t else out.reshape(-1, 1 << log_n1)


def _tail_stage(x: torch.Tensor, s: int, log_m: int,
                tt: torch.Tensor) -> torch.Tensor:
    """One cross-block DIT butterfly stage (rows of 2^log_m, stage s), for
    the stages past a K2 segment. tt: the full-length (log_m * m) table."""
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


# ---------------------------------------------------------------------------
# Four-step orchestration
# ---------------------------------------------------------------------------

def _fourstep(x: torch.Tensor, log_n: int, pre=None, reverse: bool = False,
              scale=None) -> torch.Tensor:
    """(b, n_in) -> (b, N) NTT of each row zero-padded to N = 2^log_n and
    multiplied by pre; with reverse, output k is at -k mod N; then times
    scale (1 or N factors)."""
    b = x.shape[0]
    log_n2 = _split(log_n)
    log_n1 = log_n - log_n2
    y = _k1(x, log_n, log_n2, pre)
    log_t = log_n1 - _segment_log(log_n1)
    if not log_t:
        return _k2(y, log_n, log_n2, 0, reverse, scale)
    rows = _k2(y, log_n, log_n2, log_t)
    tt = _stage_table(log_n1, x.device)
    for s in range(log_n1 - log_t, log_n1):
        rows = _tail_stage(rows, s, log_n1, tt)
    n = 1 << log_n
    out = rows.reshape(b, 1 << log_n2, 1 << log_n1).transpose(1, 2)
    out = out.reshape(b, n)
    if reverse:
        out = out.index_select(1, (-torch.arange(n, device=x.device)) % n)
    if scale is not None:
        out = gl64.mul(out, scale.expand(n) if scale.numel() == 1 else scale)
    return out


def _run(x: torch.Tensor, log_n: int, n_in: int, **kw) -> torch.Tensor:
    if x.shape[-1] != n_in:
        raise ValueError(f"last axis is {x.shape[-1]}, expected {n_in}")
    lead = x.shape[:-1]
    y = _fourstep(x.reshape(-1, n_in).contiguous(), log_n, **kw)
    return y.reshape(lead + (1 << log_n,))


# ---------------------------------------------------------------------------
# Public entry points (twins of core/ntt.py)
# ---------------------------------------------------------------------------

def ntt(x: torch.Tensor, log_n: int) -> torch.Tensor:
    return _run(x, log_n, 1 << log_n)


def intt(x: torch.Tensor, log_n: int) -> torch.Tensor:
    return _run(x, log_n, 1 << log_n, reverse=True,
                scale=_table("oscale", _out_scale, log_n, None,
                             device=x.device))


def coset_lde(coeffs: torch.Tensor, log_n: int, rate_bits: int,
              shift: int = gl64.MULTIPLICATIVE_GROUP_GENERATOR
              ) -> torch.Tensor:
    """coeffs (..., 2^log_n) -> evals (..., 2^(log_n+rate_bits)) on the
    coset shift*<w> — the commit's hot path. K1 scales by shift^j and pads
    as it reads."""
    pre = tntt._coset_table(log_n, shift % gl64.P, coeffs.device)
    return _run(coeffs, log_n + rate_bits, 1 << log_n, pre=pre)


def coset_intt(evals: torch.Tensor, log_m: int,
               shift: int = gl64.MULTIPLICATIVE_GROUP_GENERATOR
               ) -> torch.Tensor:
    return _run(evals, log_m, 1 << log_m, reverse=True,
                scale=_table("oscale", _out_scale, log_m, shift % gl64.P,
                             device=evals.device))
