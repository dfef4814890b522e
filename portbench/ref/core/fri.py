"""FRI low-degree proofs over Goldilocks^2.

The verifier's part of the port's ``core/fri.py``: the configuration, the
proof objects and ``fri_verify``, exact host-side python-int math over the
radix-2 fold rule (v(x)+v(-x))/2 + beta*(v(x)-v(-x))/(2x). The FRI prover
is the program's and is not copied.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from . import gl64, gl64_ext, merkle
from .challenger import Challenger


@dataclasses.dataclass(frozen=True)
class FriConfig:
    """Mirrors plonky2 FriConfig (standard recursion: rate 1/8, 28 queries,
    cap height 4, 16 pow bits)."""
    rate_bits: int = 3
    cap_height: int = 4
    proof_of_work_bits: int = 16
    num_query_rounds: int = 28
    final_poly_bits: int = 5        # log2(len) of the directly-sent final poly

    def num_folds(self, log_degree: int) -> int:
        return max(log_degree - self.final_poly_bits, 0)


@dataclasses.dataclass
class FriQueryLayer:
    """One layer's opening for one query: the sibling pair + Merkle path."""
    coset: list[tuple[int, int]]          # [v_j, v_{j+m/2}] as ext (int, int)
    merkle_path: list[list[int]]          # sibling digests, leaf level first


@dataclasses.dataclass
class FriProof:
    commit_caps: list[np.ndarray]         # per layer: (2^cap, 4) uint64
    final_poly: list[tuple[int, int]]     # ext coefficients
    pow_witness: int
    query_rounds: list[list[FriQueryLayer]]
    # transcript-derived (the verifier recomputes them): surfaced so callers
    # can open their own witness trees at the same indices
    query_indices: list[int] = dataclasses.field(default_factory=list)


# ---------------------------------------------------------------------------
# Device helpers
# ---------------------------------------------------------------------------

_INV_X: dict = {}


# grind gives up after this many candidate batches
_GRIND_MAX_BATCHES = 64


# ---------------------------------------------------------------------------
# Prover
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# Verifier (host, exact)
# ---------------------------------------------------------------------------

def fri_verify(proof: FriProof, log_m: int, shift: int, config: FriConfig,
               challenger: Challenger, initial_eval_fn=None) -> bool:
    """Verify a FriProof. ``initial_eval_fn(query_round, index)`` returns
    the claimed codeword value (an ext (int, int)) at a queried initial
    index, e.g. recomputed from a PLONK proof's tree openings after their
    Merkle paths are checked, or None to reject the proof. Without it,
    layer 0's own opening is trusted as the codeword's value (a standalone
    low-degree test). A proof must carry config.num_query_rounds query
    rounds (the reference's fri_verify does not check their number)."""
    log_degree = log_m - config.rate_bits
    n_folds = config.num_folds(log_degree)
    if len(proof.commit_caps) != n_folds or \
            len(proof.query_rounds) != config.num_query_rounds:
        return False

    betas = []
    for cap in proof.commit_caps:
        challenger.observe_cap(cap)
        betas.append(challenger.get_extension_challenge())
    if len(proof.final_poly) != 1 << max(log_degree - n_folds, 0):
        return False
    for c in proof.final_poly:
        challenger.observe_ext(c)
    challenger.observe_element(proof.pow_witness)
    if challenger.get_challenge() >= (1 << (64 - config.proof_of_work_bits)):
        return False

    m0 = 1 << log_m
    fin_log = log_m - n_folds
    fin_shift = shift
    for _ in range(n_folds):
        fin_shift = (fin_shift * fin_shift) % gl64.P
    w_fin = gl64.h_primitive_root_of_unity(fin_log)
    inv2 = pow(2, gl64.P - 2, gl64.P)

    for qr, round_layers in enumerate(proof.query_rounds):
        i = challenger.get_challenge() % m0
        if len(round_layers) != n_folds:
            return False
        value = None
        if initial_eval_fn is not None:
            value = initial_eval_fn(qr, i)
            if value is None:
                return False
        lm, s = log_m, shift % gl64.P
        for layer, beta, cap in zip(round_layers, betas, proof.commit_caps):
            h = 1 << (lm - 1)
            j = i % h
            vj, vjh = layer.coset
            claimed = vjh if i >= h else vj
            if value is not None and tuple(claimed) != tuple(value):
                return False
            leaf_digest = merkle.h_hash_leaf([vj[0], vj[1], vjh[0], vjh[1]])
            if not merkle.h_verify_merkle_proof(
                    leaf_digest, j, layer.merkle_path, cap):
                return False
            # fold
            w = gl64.h_primitive_root_of_unity(lm)
            x = (s * pow(w, j, gl64.P)) % gl64.P
            inv2x = pow(2 * x, gl64.P - 2, gl64.P)
            sum_ = gl64_ext.h_add(vj, vjh)
            diff = gl64_ext.h_sub(vj, vjh)
            even = ((sum_[0] * inv2) % gl64.P, (sum_[1] * inv2) % gl64.P)
            odd = ((diff[0] * inv2x) % gl64.P, (diff[1] * inv2x) % gl64.P)
            value = gl64_ext.h_add(even, gl64_ext.h_mul(beta, odd))
            i = j
            lm -= 1
            s = (s * s) % gl64.P
        # final check: value == final_poly(x_i) on the final coset
        x = (fin_shift * pow(w_fin, i, gl64.P)) % gl64.P
        acc = (0, 0)
        for c in reversed(proof.final_poly):
            acc = gl64_ext.h_mul(acc, (x, 0))
            acc = gl64_ext.h_add(acc, c)
        if acc != tuple(value):
            return False
    return True
