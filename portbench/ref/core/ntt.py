"""Number-theoretic transform (radix-2) and coset LDE over Goldilocks.

Polynomials are int64 tensors of shape ``(..., N)``, batched along the
leading dims, as in the reference (``city_rollup_tpu/core/ntt.py``).

Every tensor, on any device, runs the plain radix-2 version here: one
bit-reversal gather, then log2(N) butterfly stages, each one elementwise
pass.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import gl64


# ---------------------------------------------------------------------------
# Host-side tables (python-int exact; cached per size)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _root_powers(log_n: int) -> np.ndarray:
    """w^0 .. w^(N/2 - 1) for w the 2^log_n-th primitive root, as uint64."""
    n = 1 << log_n
    w = gl64.h_primitive_root_of_unity(log_n)
    return gl64.np_powers(w, max(n // 2, 1))


@functools.lru_cache(maxsize=None)
def _inv_root_powers(log_n: int) -> np.ndarray:
    n = 1 << log_n
    w_inv = gl64.h_inverse(gl64.h_primitive_root_of_unity(log_n))
    return gl64.np_powers(w_inv, max(n // 2, 1))


@functools.lru_cache(maxsize=None)
def _bit_reverse_perm(log_n: int) -> np.ndarray:
    n = 1 << log_n
    idx = np.arange(n, dtype=np.uint32)
    rev = np.zeros(n, dtype=np.uint32)
    for b in range(log_n):
        rev |= ((idx >> b) & 1) << (log_n - 1 - b)
    return rev.astype(np.int32)


@functools.lru_cache(maxsize=None)
def _coset_powers(log_n: int, shift: int) -> np.ndarray:
    """shift^0 .. shift^(N-1) as uint64 (for coset NTT input scaling)."""
    return gl64.np_powers(shift, 1 << log_n)


# Device copies of the tables, keyed by (table key, device): built once per
# device, then reused by every call.
_DEV_TABLES: dict = {}


def _dev_table(key, fn, device) -> torch.Tensor:
    """Device-resident int64 copy of a host table (uint64 values or int
    indices), cached by (key, device)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    k = (key, str(device))
    ent = _DEV_TABLES.get(k)
    if ent is None:
        arr = np.ascontiguousarray(fn())
        if arr.dtype == np.uint64:
            arr = arr.view(np.int64)
        ent = torch.from_numpy(arr.astype(np.int64)).to(device)
        _DEV_TABLES[k] = ent
    return ent


def _perm(log_n: int, device) -> torch.Tensor:
    return _dev_table(("brev", log_n), lambda: _bit_reverse_perm(log_n),
                      device)


def _root_table(log_n: int, inverse: bool, device) -> torch.Tensor:
    if inverse:
        return _dev_table(("ipow", log_n), lambda: _inv_root_powers(log_n),
                          device)
    return _dev_table(("pow", log_n), lambda: _root_powers(log_n), device)


def _coset_table(log_n: int, shift: int, device) -> torch.Tensor:
    return _dev_table(("coset", log_n, shift),
                      lambda: _coset_powers(log_n, shift), device)


# ---------------------------------------------------------------------------
# Plain radix-2 transform (CPU tensors)
# ---------------------------------------------------------------------------

def _ntt_core(x: torch.Tensor, pows: torch.Tensor, log_n: int):
    """Iterative radix-2 DIT NTT along the last axis; stage twiddles are
    strided slices of the root-power table."""
    n = 1 << log_n
    batch = x.shape[:-1]
    x = x.index_select(-1, _perm(log_n, x.device))
    for s in range(log_n):
        half = 1 << s
        blocks = n // (2 * half)
        tw = pows[::blocks][:half]
        v = x.reshape(batch + (blocks, 2, half))
        even, odd = v[..., 0, :], v[..., 1, :]
        t = gl64.mul(odd, tw)
        x = torch.stack([gl64.add(even, t), gl64.sub(even, t)],
                        dim=-2).reshape(batch + (n,))
    return x


def _check(x: torch.Tensor, n: int):
    if x.dtype != torch.int64:
        raise TypeError(f"expected int64, got {x.dtype}")
    if x.shape[-1] != n:
        raise ValueError(f"last axis is {x.shape[-1]}, expected {n}")


def _scale_const(x: torch.Tensor, c: int) -> torch.Tensor:
    return gl64.mul(x, torch.full_like(x, gl64.to_i64(c)))


def ntt(x: torch.Tensor, log_n: int) -> torch.Tensor:
    """Forward NTT: coefficients -> evaluations on the 2^log_n subgroup."""
    _check(x, 1 << log_n)
    return _ntt_core(x, _root_table(log_n, False, x.device), log_n)


def intt(x: torch.Tensor, log_n: int) -> torch.Tensor:
    """Inverse NTT: evaluations -> coefficients (includes 1/N scaling)."""
    _check(x, 1 << log_n)
    y = _ntt_core(x, _root_table(log_n, True, x.device), log_n)
    return _scale_const(y, gl64.h_inverse(1 << log_n))


def _coset_scale_pad(coeffs: torch.Tensor, log_n: int, rate_bits: int,
                     shift: int) -> torch.Tensor:
    """coeffs * shift^i, zero-padded to 2^(log_n + rate_bits)."""
    n = 1 << log_n
    scaled = gl64.mul(coeffs, _coset_table(log_n, shift % gl64.P,
                                           coeffs.device))
    out = coeffs.new_zeros(coeffs.shape[:-1] + (n << rate_bits,))
    out[..., :n] = scaled
    return out


def coset_lde(coeffs: torch.Tensor, log_n: int, rate_bits: int,
              shift: int = gl64.MULTIPLICATIVE_GROUP_GENERATOR
              ) -> torch.Tensor:
    """Low-degree extension: coeffs (..., 2^log_n) -> evals
    (..., 2^(log_n+rate_bits)) on the coset shift * <w>."""
    _check(coeffs, 1 << log_n)
    padded = _coset_scale_pad(coeffs, log_n, rate_bits, shift)
    log_m = log_n + rate_bits
    return _ntt_core(padded, _root_table(log_m, False, coeffs.device), log_m)


def coset_intt(evals: torch.Tensor, log_m: int,
               shift: int = gl64.MULTIPLICATIVE_GROUP_GENERATOR
               ) -> torch.Tensor:
    """Inverse of evaluation on coset shift * <w>: evals -> coefficients."""
    _check(evals, 1 << log_m)
    inv_shift = gl64.h_inverse(shift % gl64.P)
    c = intt(evals, log_m)
    return gl64.mul(c, _coset_table(log_m, inv_shift, evals.device))


# ---------------------------------------------------------------------------
# Host reference (exact, python ints; for tests on small sizes)
# ---------------------------------------------------------------------------

def h_ntt(coeffs: list[int], log_n: int) -> list[int]:
    n = 1 << log_n
    assert len(coeffs) == n
    w = gl64.h_primitive_root_of_unity(log_n)
    # naive O(n^2) evaluation — ground truth
    out = []
    wk = 1
    for _ in range(n):
        acc = 0
        xp = 1
        for c in coeffs:
            acc = (acc + c * xp) % gl64.P
            xp = (xp * wk) % gl64.P
        out.append(acc)
        wk = (wk * w) % gl64.P
    return out


def h_eval_poly(coeffs: list[int], x: int) -> int:
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % gl64.P
    return acc
