"""The least time the H100 could take for a kernel call: the larger of its
bytes over the memory bandwidth and its operations over the operation
rate, each input byte read once and each output byte written once.

A copy of the bound arithmetic that ``chip_smoke.py`` keeps beside the
port's kernel table, so that a later change to the program cannot move the
yardstick. Peaks: the H100 SXM data sheet at 700 W.
"""

from __future__ import annotations

MEM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12
# A Goldilocks multiply is four 32x32 -> 64 products of two multiply-adds
# each (16 operations); an MDS entry times a u64 is two multiply-adds (4
# operations). Adds, compares and reductions are not counted, so the count
# is a lower bound.
OPS_MULMOD = 16
OPS_MDS_ENTRY = 4
OPS_PERMUTATION = (8 * 12 * 4 + 22 * 4) * OPS_MULMOD + 30 * 144 * OPS_MDS_ENTRY
RATE = 8        # the sponge's rate: felts absorbed per permutation


def ntt_bound_s(rows: int, n_in: int, n_out: int) -> float:
    """One K1 + K2 transform of `rows` rows, n_in values each in and n_out
    out: the input read once, the output written once (bytes bound)."""
    return 8 * rows * (n_in + n_out) / MEM_BYTES_PER_S


def _larger(n_bytes: float, ops: float) -> float:
    return max(n_bytes / MEM_BYTES_PER_S, ops / OPS_PER_S)


def sponge_bound_s(n: int, cols: int) -> float:
    """K4 sponge: (n, cols) felts in, (4, cols) digests out, ceil(n / 8)
    permutations a column."""
    return _larger(8 * (n + 4) * cols, -(-n // RATE) * OPS_PERMUTATION * cols)


def level_bound_s(parents: int) -> float:
    """K4's Merkle-level entry: (4, 2P) digests in, (4, P) out, one
    permutation a parent."""
    return _larger(8 * (8 + 4) * parents, OPS_PERMUTATION * parents)


def permute_bound_s(cols: int) -> float:
    """K3: (12, cols) states in and out, one permutation a column."""
    return _larger(8 * (12 + 12) * cols, OPS_PERMUTATION * cols)


def absorb_bound_s(k: int, cols: int) -> float:
    """K5: (12, cols) states and (k, cols) felts in, (12, cols) out, one
    permutation a column."""
    return _larger(8 * (12 + k + 12) * cols, OPS_PERMUTATION * cols)
