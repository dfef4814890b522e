"""FRI low-degree proofs over Goldilocks^2.

Counterpart of the reference's ``core/fri.py``; the same codeword and
transcript give an equal ``FriProof``, field for field.

Commit phase: every fold layer's codeword (natural order, extension field)
is committed as a Poseidon Merkle cap (the sponge kernel, one launch per
tree level); the fold is elementwise PyTorch over ``gl64_ext`` (the radix-2
rule (v(x)+v(-x))/2 + beta*(v(x)-v(-x))/(2x)), as the reference does it in
jnp. Grinding (proof-of-work) permutes a batch of candidate transcripts at
once (the permutation kernel on a CUDA tensor). As in the reference, each
layer's codeword and tree levels are copied to the host, where the
challenger and the query openings run on python ints.

Codewords are pairs ``(a0, a1)`` of int64 tensors of shape (m,), or (B, m)
for ``fri_prove_batch``; numpy uint64 pairs are taken too. Both provers run
on CUDA unless ``device="cpu"`` is given. The verifier is exact host-side
python-int math.
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch

from .. import convert
from . import gl64, gl64_ext, merkle, ntt, poseidon
from .challenger import Challenger
from .poseidon_params import SPONGE_RATE


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

def _ext_codeword_to_leaves(codeword) -> torch.Tensor:
    """Ext codeword (a0, a1) of length m -> (..., m/2, 4) leaf felts pairing
    index j with j + m/2 (the radix-2 fold sibling). Leading batch dims ride
    through."""
    a0, a1 = codeword
    h = a0.shape[-1] // 2
    return torch.stack([a0[..., :h], a1[..., :h], a0[..., h:], a1[..., h:]],
                       dim=-1)


_INV_X: dict = {}


def _fold_inv_x_table(log_m: int, shift: int, device) -> torch.Tensor:
    """1/(2*x_j) for j in [0, m/2): inv(2*shift) * w^{-j}, cached on the
    device per (log_m, shift, device)."""
    key = (log_m, shift, str(device))
    ent = _INV_X.get(key)
    if ent is None:
        h = 1 << (log_m - 1)
        w_inv = gl64.h_inverse(gl64.h_primitive_root_of_unity(log_m))
        base = gl64.h_inverse((2 * shift) % gl64.P)
        vals = gl64.np_mul(gl64.np_powers(w_inv, h), np.uint64(base))
        ent = convert.from_u64(vals, device)
        _INV_X[key] = ent
    return ent


def _fold_codeword(codeword, betas: torch.Tensor, log_m: int, shift: int):
    """One radix-2 fold of codeword arrays (..., m) -> (..., m/2). betas:
    int64 (..., 2) on the codeword's device, one ext challenge per codeword,
    so (B, 2) folds B codewords in one pass."""
    a0, a1 = codeword
    h = 1 << (log_m - 1)
    ve = (a0[..., :h], a1[..., :h])                 # v(x)
    vo = (a0[..., h:], a1[..., h:])                 # v(-x)
    s = gl64_ext.add(ve, vo)
    d = gl64_ext.sub(ve, vo)
    even = gl64_ext.mul_base(
        s, gl64.full((), gl64.h_inverse(2), a0.device))   # (v + v-)/2
    odd = gl64_ext.mul_base(
        d, _fold_inv_x_table(log_m, shift % gl64.P, a0.device))  # (v - v-)/2x
    beta = (betas[..., 0:1], betas[..., 1:2])
    return gl64_ext.add(even, gl64_ext.mul(beta, odd))


def _betas(values, device) -> torch.Tensor:
    """Ext challenges [(int, int), ...] -> int64 (len, 2) on the device."""
    return convert.from_u64(np.array(values, dtype=np.uint64), device)


# grind gives up after this many candidate batches
_GRIND_MAX_BATCHES = 64


def grind(challenger: Challenger, pow_bits: int, device=None) -> int:
    """The first pow_witness w, in candidate order, such that the challenge
    drawn right after observing w has `pow_bits` leading zero bits. Each
    batch of candidates is one batched permutation (``poseidon.permute``),
    sized ~4x the expected search length. Runs on CUDA unless ``device``
    says otherwise."""
    base = copy.deepcopy(challenger)
    k = len(base.input_buffer)
    if k + 1 > SPONGE_RATE:
        raise ValueError("the challenger's input buffer is full")
    threshold = 1 << (64 - pow_bits)
    state = np.array(base.state, dtype=np.uint64)
    batch = max(256, min(1 << 17, 4 << pow_bits))
    start = 0
    for _ in range(_GRIND_MAX_BATCHES):
        ws = np.arange(start, start + batch, dtype=np.uint64)
        start += batch
        states = np.tile(state, (batch, 1))
        if k:
            states[:, :k] = np.array(base.input_buffer, dtype=np.uint64)
        states[:, k] = ws
        out = poseidon.permute(convert.from_u64(states, device))
        c = convert.to_u64(out[:, SPONGE_RATE - 1])
        hits = np.nonzero(c < threshold)[0]
        if hits.size:
            return int(ws[hits[0]])
    raise RuntimeError("grind failed")


def _as_codeword(codeword, device):
    return (convert.as_tensor(codeword[0], device),
            convert.as_tensor(codeword[1], device))


def _final_poly_coeffs(cur, cur_log: int, cur_shift: int, n_coeffs: int):
    """Interpolate the last codeword(s) on their coset: host (..., m) uint64
    coefficient arrays, checked to vanish from n_coeffs on."""
    c0 = convert.to_u64(ntt.coset_intt(cur[0], cur_log, shift=cur_shift))
    c1 = convert.to_u64(ntt.coset_intt(cur[1], cur_log, shift=cur_shift))
    if c0[..., n_coeffs:].any() or c1[..., n_coeffs:].any():
        raise ValueError("codeword is not low-degree")
    return c0, c1


# ---------------------------------------------------------------------------
# Prover
# ---------------------------------------------------------------------------

def fri_prove(codeword, log_m: int, shift: int, config: FriConfig,
              challenger: Challenger, device=None) -> FriProof:
    """Prove the ext codeword (natural order, on coset shift*<w_m>) is the
    LDE of a polynomial of degree < 2^(log_m - rate_bits).

    codeword: (a0, a1) int64 tensors or numpy uint64 arrays of shape
    (2^log_m,). The first commit round commits this initial codeword
    (layer 0), matching plonky2's transcript shape. This is
    fri_prove_batch on a batch of one."""
    a0, a1 = _as_codeword(codeword, device)
    return fri_prove_batch((a0[None], a1[None]), log_m, shift, config,
                           [challenger], device=a0.device)[0]


def fri_prove_batch(codewords, log_m: int, shift: int, config: FriConfig,
                    challengers: list, device=None) -> list[FriProof]:
    """Batched FRI: B codewords (arrays shaped (B, 2^log_m)) with B
    independent transcripts. Every fold and every layer's Merkle level is
    one pass for the whole batch; challenges, grinding and query sampling
    stay per proof (the proofs equal fri_prove's one at a time)."""
    bsz = len(challengers)
    log_degree = log_m - config.rate_bits
    n_folds = config.num_folds(log_degree)
    cur = _as_codeword(codewords, device)
    if cur[0].shape[0] != bsz:
        raise ValueError(f"{cur[0].shape[0]} codewords, {bsz} challengers")
    cur_log, cur_shift = log_m, shift % gl64.P
    layers = []
    caps_per_proof = [[] for _ in range(bsz)]
    for _ in range(n_folds):
        tree = merkle.BatchedMerkleTree(
            _ext_codeword_to_leaves(cur),
            cap_height=min(config.cap_height, cur_log - 1))
        cw_np = (convert.to_u64(cur[0]), convert.to_u64(cur[1]))
        layers.append((cw_np, tree, cur_log))
        betas = []
        for b in range(bsz):
            cap = tree.cap_u64(b)
            caps_per_proof[b].append(cap)
            challengers[b].observe_cap(cap)
            betas.append(challengers[b].get_extension_challenge())
        cur = _fold_codeword(cur, _betas(betas, cur[0].device), cur_log,
                             cur_shift)
        cur_shift = (cur_shift * cur_shift) % gl64.P
        cur_log -= 1

    n_coeffs = 1 << max(cur_log - config.rate_bits, 0)
    c0, c1 = _final_poly_coeffs(cur, cur_log, cur_shift, n_coeffs)
    # the transcript tail of each proof: observe the final polynomial,
    # grind on the device, draw the query indices and open every layer
    m0 = 1 << log_m
    proofs = []
    for b, ch in enumerate(challengers):
        final_poly = [(int(c0[b, i]), int(c1[b, i]))
                      for i in range(n_coeffs)]
        for c in final_poly:
            ch.observe_ext(c)
        pow_witness = grind(ch, config.proof_of_work_bits,
                            device=cur[0].device)
        ch.observe_element(pow_witness)
        if ch.get_challenge() >= 1 << (64 - config.proof_of_work_bits):
            raise RuntimeError("grind returned a witness that misses the "
                               "target")
        query_rounds, query_indices = [], []
        for _ in range(config.num_query_rounds):
            i = ch.get_challenge() % m0
            query_indices.append(i)
            round_layers = []
            for (a0, a1), tree, lm in layers:
                h = 1 << (lm - 1)
                j = i % h
                round_layers.append(FriQueryLayer(
                    coset=[(int(a0[b, j]), int(a1[b, j])),
                           (int(a0[b, j + h]), int(a1[b, j + h]))],
                    merkle_path=tree.prove(b, j)))
                i = j
            query_rounds.append(round_layers)
        proofs.append(FriProof(commit_caps=caps_per_proof[b],
                               final_poly=final_poly,
                               pow_witness=pow_witness,
                               query_rounds=query_rounds,
                               query_indices=query_indices))
    return proofs


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
