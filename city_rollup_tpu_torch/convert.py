"""Carry values across between the reference and the port.

The port holds a Goldilocks value as one ``torch.int64`` element whose bits
are the u64 value. The reference (``city_rollup_tpu``) holds it as a
``(lo, hi)`` pair of uint32 arrays. Tests feed both sides the same numpy
inputs through these functions.
"""

from __future__ import annotations

import numpy as np
import torch

from . import device as _device

_MASK32 = np.uint64(0xFFFFFFFF)


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


def from_jax_pair(lo, hi, device=None) -> torch.Tensor:
    """The reference's (lo, hi) uint32 pair -> int64 tensor."""
    lo = np.asarray(lo, dtype=np.uint64)
    hi = np.asarray(hi, dtype=np.uint64)
    return from_u64(lo | (hi << np.uint64(32)), device)


def to_jax_pair(t: torch.Tensor) -> tuple[np.ndarray, np.ndarray]:
    """int64 tensor -> the reference's (lo, hi) uint32 pair (numpy)."""
    x = to_u64(t)
    return ((x & _MASK32).astype(np.uint32),
            (x >> np.uint64(32)).astype(np.uint32))


def from_jax_ext(ext, device=None):
    """The reference's ext value ((a0lo, a0hi), (a1lo, a1hi)) -> (a0, a1)
    int64 tensors."""
    return (from_jax_pair(*ext[0], device=device),
            from_jax_pair(*ext[1], device=device))


def to_jax_ext(ext):
    """(a0, a1) int64 tensors -> the reference's ((a0lo, a0hi),
    (a1lo, a1hi)) uint32 pairs (numpy)."""
    return (to_jax_pair(ext[0]), to_jax_pair(ext[1]))


def fri_proof_equal(a, b) -> bool:
    """Whether two FriProofs (of either package) agree field for field."""
    def rounds(p):
        return [[([tuple(map(int, v)) for v in layer.coset],
                  [list(map(int, d)) for d in layer.merkle_path])
                 for layer in rnd] for rnd in p.query_rounds]

    return (len(a.commit_caps) == len(b.commit_caps)
            and all(np.array_equal(np.asarray(x, dtype=np.uint64),
                                   np.asarray(y, dtype=np.uint64))
                    for x, y in zip(a.commit_caps, b.commit_caps))
            and [tuple(map(int, c)) for c in a.final_poly]
            == [tuple(map(int, c)) for c in b.final_poly]
            and int(a.pow_witness) == int(b.pow_witness)
            and list(map(int, a.query_indices))
            == list(map(int, b.query_indices))
            and rounds(a) == rounds(b))


def as_tensor(x, device=None) -> torch.Tensor:
    """An entry point's input on the device it runs on: a numpy uint64
    array is converted, a tensor is moved (int64 only)."""
    dev = _device(device)
    if isinstance(x, torch.Tensor):
        if x.dtype != torch.int64:
            raise TypeError(f"expected int64, got {x.dtype}")
        return x.to(dev)
    return from_u64(x, dev)


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
    from .snark.prover import InitialTreeOpening, OpeningSet, Proof

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
