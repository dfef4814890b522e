"""Fiat-Shamir challenger: a Poseidon duplex sponge over Goldilocks.

A copy of the reference's ``core/challenger.py`` over the port's
``poseidon_host``: host-only, exact python ints. The transcript is
sequential and small (a few hundred permutations per proof), so it stays on
the host. Semantics follow plonky2's ``Challenger``: observed elements fill
an input buffer; a duplex overwrites the state's rate with it, permutes,
and refills the output buffer; challenges pop from the output buffer.
"""

from __future__ import annotations

from . import gl64, poseidon_host
from .poseidon_params import SPONGE_RATE, WIDTH


class Challenger:
    def __init__(self):
        self.state = [0] * WIDTH
        self.input_buffer: list[int] = []
        self.output_buffer: list[int] = []

    # -- observing ---------------------------------------------------------
    def observe_element(self, x: int):
        if not 0 <= x < gl64.P:
            raise ValueError(f"{x} is not a canonical field element")
        self.output_buffer.clear()
        self.input_buffer.append(x)
        if len(self.input_buffer) == SPONGE_RATE:
            self._duplex()

    def observe_elements(self, xs):
        for x in xs:
            self.observe_element(int(x))

    def observe_hash(self, h):
        """Observe a 4-felt digest."""
        if len(h) != 4:
            raise ValueError(f"a digest has 4 felts, got {len(h)}")
        self.observe_elements(h)

    def observe_cap(self, cap):
        """Observe a Merkle cap: iterable of 4-felt digests."""
        for d in cap:
            self.observe_hash([int(x) for x in d])

    def observe_ext(self, x):
        """Observe an extension-field element (a0, a1)."""
        self.observe_element(x[0])
        self.observe_element(x[1])

    # -- squeezing ---------------------------------------------------------
    def get_challenge(self) -> int:
        if self.input_buffer or not self.output_buffer:
            self._duplex()
        return self.output_buffer.pop()

    def get_n_challenges(self, n: int) -> list[int]:
        return [self.get_challenge() for _ in range(n)]

    def get_extension_challenge(self) -> tuple[int, int]:
        a0 = self.get_challenge()
        a1 = self.get_challenge()
        return (a0, a1)

    def get_hash(self) -> list[int]:
        return self.get_n_challenges(4)

    # -- internals ----------------------------------------------------------
    def _duplex(self):
        for i, x in enumerate(self.input_buffer):
            self.state[i] = x
        self.input_buffer.clear()
        self.state = poseidon_host.permute(self.state)
        self.output_buffer = list(self.state[:SPONGE_RATE])
