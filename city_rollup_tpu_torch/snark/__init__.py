"""The SNARK layer: a Plonky2-class PLONK+FRI proving system, on PyTorch.

Counterpart of the reference's ``snark/``: gate-per-row trace with
routed-wire copy constraints (permutation argument with partial products),
selector-group gate filters, coset-LDE rate 8, Poseidon Merkle caps, FRI
opening proofs. Every polynomial-sized pass runs on the circuit's device
(wire LDEs, constraint evaluation over the 8n coset, quotient
interpolation, Merkle hashing, FRI folds); circuit building, witness
generation, Fiat-Shamir transcripts and the verifier are host Python.
"""

from .config import CircuitConfig
from .circuit import CircuitBuilder
