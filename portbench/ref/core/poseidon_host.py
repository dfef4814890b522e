"""Exact host-side (pure python int) Poseidon reference — ground truth for the
JAX/Pallas implementations and the engine for host-side transcript hashing where
scalar latency beats device round-trips (Fiat-Shamir challenger, circuit
fingerprints). Mirrors plonky2 PoseidonHash semantics (sponge rate 8, capacity 4,
no padding; reference usage: city_crypto/src/hash/qhashout.rs,
traits/hasher.rs)."""

from __future__ import annotations

import operator

from .gl64 import P
from . import poseidon_params as params


# the MDS layer as one 12 x 12 matrix: row r holds circ[(j - r) % 12] at
# column j, plus diag[r] at column r (the circulant-plus-diagonal form the
# reference's _mds sums term by term)
_MDS_ROWS = [[params.MDS_MATRIX_CIRC[(j - r) % params.WIDTH] +
              (params.MDS_MATRIX_DIAG[r] if j == r else 0)
              for j in range(params.WIDTH)] for r in range(params.WIDTH)]


def _mds(state: list[int]) -> list[int]:
    return [sum(map(operator.mul, row, state)) % P for row in _MDS_ROWS]


def _sbox(x: int) -> int:
    x2 = (x * x) % P
    x3 = (x2 * x) % P
    x6 = (x3 * x3) % P
    return (x6 * x) % P


def permute(state: list[int]) -> list[int]:
    """One Poseidon permutation over a width-12 state of canonical ints."""
    assert len(state) == params.WIDTH
    rc = params.ALL_ROUND_CONSTANTS
    w = params.WIDTH
    state = list(state)
    r = 0
    for _ in range(params.HALF_N_FULL_ROUNDS):
        state = [(s + rc[r * w + i]) % P for i, s in enumerate(state)]
        state = [_sbox(s) for s in state]
        state = _mds(state)
        r += 1
    for _ in range(params.N_PARTIAL_ROUNDS):
        state = [(s + rc[r * w + i]) % P for i, s in enumerate(state)]
        state[0] = _sbox(state[0])
        state = _mds(state)
        r += 1
    for _ in range(params.HALF_N_FULL_ROUNDS):
        state = [(s + rc[r * w + i]) % P for i, s in enumerate(state)]
        state = [_sbox(s) for s in state]
        state = _mds(state)
        r += 1
    return state


def hash_n_to_m_no_pad(inputs: list[int], num_outputs: int) -> list[int]:
    """Sponge with rate 8, capacity 4, no padding (plonky2 hash_n_to_m_no_pad)."""
    rate = params.SPONGE_RATE
    state = [0] * params.WIDTH
    for chunk_start in range(0, len(inputs), rate):
        chunk = inputs[chunk_start:chunk_start + rate]
        state[:len(chunk)] = chunk
        state = permute(state)
    outputs = []
    while True:
        for item in state[:rate]:
            outputs.append(item)
            if len(outputs) == num_outputs:
                return outputs
        state = permute(state)


def hash_no_pad(inputs: list[int]) -> list[int]:
    """4-felt digest of a felt sequence (HashOut)."""
    return hash_n_to_m_no_pad(inputs, 4)


def two_to_one(left: list[int], right: list[int]) -> list[int]:
    """Compress two 4-felt digests into one (Merkle interior node)."""
    assert len(left) == 4 and len(right) == 4
    state = list(left) + list(right) + [0] * params.SPONGE_CAPACITY
    return permute(state)[:4]


def hash_or_noop(inputs: list[int]) -> list[int]:
    """plonky2 hash_or_noop: <=4 felts pass through (zero-padded), else hash."""
    if len(inputs) <= 4:
        return list(inputs) + [0] * (4 - len(inputs))
    return hash_no_pad(inputs)
