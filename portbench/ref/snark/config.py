"""Circuit configuration: a copy of the reference's ``snark/config.py``
over the port's ``core/fri.FriConfig`` (CircuitConfig::
standard_recursion_config twin; BASELINE.md 'Recursion config' row)."""

from __future__ import annotations

import dataclasses

from ..core.fri import FriConfig


@dataclasses.dataclass(frozen=True)
class CircuitConfig:
    num_routed_wires: int = 32          # columns subject to copy constraints
    num_wires: int = 32                 # total trace columns (>= routed)
    num_constants: int = 2              # circuit constant columns
    num_challenges: int = 2             # permutation-argument repetitions
    max_constraint_degree: int = 8      # quotient degree factor
    zk: bool = False                    # witness-blinding mode (below)
    fri: FriConfig = dataclasses.field(default_factory=FriConfig)

    @property
    def num_blinding_rows(self) -> int:
        """zk mode (reference: standard_recursion_zk_config, used by the
        zk-signature inner circuit, zk_signature/inner.rs:50): the prover
        fills this many gate-less padding rows of EVERY wire column with
        fresh randomness. Padding rows run no gate (sentinel selector
        filters every constraint) and are copy-constraint fixed points
        (ratio 1 in the permutation argument), so soundness is unchanged;
        with more blinding rows than total opened evaluations per polynomial
        (zeta + FRI query openings), the openings of the wire polynomials
        are statistically independent of the witness. plonky2 additionally
        salts the Merkle leaves; that (and blinding of the Z/partial-product
        columns) is the remaining delta to its exact zk config."""
        return self.fri.num_query_rounds + 4 if self.zk else 0

    # permutation-argument chunking: 7 factors/step keeps degree <= 8
    @property
    def perm_chunk_size(self) -> int:
        return self.max_constraint_degree - 1

    @property
    def num_perm_chunks(self) -> int:
        c = self.perm_chunk_size
        return (self.num_routed_wires + c - 1) // c

    @property
    def num_partial_products(self) -> int:
        """Extra witness columns per challenge (the last chunk lands in
        Z(g x) directly)."""
        return self.num_perm_chunks - 1

    @property
    def rate_bits(self) -> int:
        return self.fri.rate_bits

    @property
    def quotient_chunks(self) -> int:
        return self.max_constraint_degree

    @classmethod
    def poseidon_config(cls, **kw) -> "CircuitConfig":
        """Wide-trace config fitting the 142-wire PoseidonGate (the analogue
        of plonky2's 135-wire standard_recursion_config)."""
        kw.setdefault("num_wires", 144)
        return cls(**kw)


# selector sentinel for rows whose gate is in another selector group
UNUSED_SELECTOR = (1 << 32) - 1
