"""Goldilocks values between numpy uint64 and the int64 tensors whose bits
are the u64 value, and a proof as plain data (``proof_to_plain`` reads the
program's proof by its fields; ``proof_from_plain`` gives the reference's
``Proof``), so that the check holds no object of the program.
"""

from __future__ import annotations

import numpy as np
import torch

from . import device as _device

def from_u64(x, device=None) -> torch.Tensor:
    """numpy uint64 array (or array-like of ints < 2^64) -> int64 tensor."""
    arr = np.ascontiguousarray(np.asarray(x, dtype=np.uint64))
    t = torch.from_numpy(arr.view(np.int64).copy())
    return t.to(_device(device))


def to_u64(t: torch.Tensor) -> np.ndarray:
    """int64 tensor (any device) -> numpy uint64 array on the host."""
    if t.dtype != torch.int64:
        raise TypeError(f"expected int64, got {t.dtype}")
    return t.detach().cpu().contiguous().numpy().view(np.uint64).copy()


def _ints(x):
    """Nested sequences (lists, tuples, arrays) -> nested lists of ints."""
    if isinstance(x, np.ndarray):
        return x.astype(object).tolist() if x.ndim else int(x)
    if isinstance(x, (list, tuple)):
        return [_ints(v) for v in x]
    return int(x)


def proof_to_plain(proof) -> list:
    """A snark Proof (of either package) as nested lists of python ints,
    in field order: [public_inputs, wires_cap, zs_pp_cap, quotient_cap,
    openings [constants_sigmas, wires, zs, pps, quotient, zs_next],
    fri_proof [commit_caps, final_poly, pow_witness, query_rounds (per
    round, per layer: [coset, merkle_path]), query_indices],
    initial_openings (per round: [values, paths])]."""
    o, f = proof.openings, proof.fri_proof
    return [
        _ints(proof.public_inputs), _ints(proof.wires_cap),
        _ints(proof.zs_pp_cap), _ints(proof.quotient_cap),
        _ints([o.constants_sigmas, o.wires, o.zs, o.pps, o.quotient,
               o.zs_next]),
        [_ints(f.commit_caps), _ints(f.final_poly), int(f.pow_witness),
         [[[_ints(layer.coset), _ints(layer.merkle_path)]
           for layer in rnd] for rnd in f.query_rounds],
         _ints(f.query_indices)],
        [[_ints(io.values), _ints(io.paths)]
         for io in proof.initial_openings]]


def proof_from_plain(plain: list):
    """proof_to_plain's output -> the port's snark Proof."""
    from .core.fri import FriProof, FriQueryLayer
    from .snark.proof import InitialTreeOpening, OpeningSet, Proof

    def cap(c):
        return np.array(c, dtype=np.uint64).reshape(-1, 4)

    def ext(vals):
        return [tuple(v) for v in vals]

    pis, wcap, zcap, qcap, opens, fp, initial = plain
    caps, final_poly, pow_witness, rounds, indices = fp
    return Proof(
        public_inputs=list(pis), wires_cap=cap(wcap), zs_pp_cap=cap(zcap),
        quotient_cap=cap(qcap),
        openings=OpeningSet(*[ext(v) for v in opens]),
        fri_proof=FriProof(
            commit_caps=[cap(c) for c in caps], final_poly=ext(final_poly),
            pow_witness=pow_witness,
            query_rounds=[[FriQueryLayer(coset=ext(coset),
                                         merkle_path=[list(d) for d in path])
                           for coset, path in rnd] for rnd in rounds],
            query_indices=list(indices)),
        initial_openings=[InitialTreeOpening(values=[list(v) for v in vals],
                                             paths=[[list(d) for d in p]
                                                    for p in paths])
                          for vals, paths in initial])
