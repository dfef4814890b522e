"""The proof's objects and the public inputs' hash: the part of the port's
``snark/prover.py`` that the verifier and the recursion gadget read (the
prover itself is the program's, and no check runs it here)."""

from __future__ import annotations

import dataclasses

import numpy as np

from ..core import fri, gl64, poseidon_host

P = gl64.P
SALT_WIDTH = 4      # salt felts per committed leaf in zk mode (plonky2 SALT_SIZE)


@dataclasses.dataclass
class OpeningSet:
    constants_sigmas: list      # ext (int,int) per preprocessing poly
    wires: list
    zs: list                    # Z_c(zeta)
    pps: list                   # partial products (challenge-major)
    quotient: list              # chunks (challenge-major)
    zs_next: list               # Z_c(g*zeta)

    def flat(self):
        return (self.constants_sigmas + self.wires + self.zs + self.pps +
                self.quotient + self.zs_next)


@dataclasses.dataclass
class InitialTreeOpening:
    values: list[list[int]]     # per tree: leaf row (all polys at the index)
    paths: list[list[list[int]]]


@dataclasses.dataclass
class Proof:
    public_inputs: list[int]
    wires_cap: np.ndarray
    zs_pp_cap: np.ndarray
    quotient_cap: np.ndarray
    openings: OpeningSet
    fri_proof: fri.FriProof
    initial_openings: list[InitialTreeOpening]   # one per query round


def public_inputs_hash(pis: list[int]) -> list[int]:
    """<=4 PIs pass through zero-padded; more are Poseidon-hashed (matches
    CircuitBuilder.build's public-input wiring)."""
    pis = [int(v) % P for v in pis]
    if len(pis) > 4:
        return poseidon_host.hash_no_pad(pis)
    return (pis + [0, 0, 0, 0])[:4]
