"""SHA256 accelerator: batch every sha256 request of a circuit family into
ONE dedicated proof, verified recursively by the requesting circuit, with
digests wired back by commitment instead of in-circuit recomputation.

Reference role: the starkyx bridge
(city_common_circuit/src/hash/accelerator/sha256/{planner, smartgadget,
gadget}.rs — SURVEY.md §2.2 "SHA256 accelerator"): the reference collects
all sha256 preimage requests into domains, proves every padded chunk in one
`ByteStark` AIR, verifies that STARK inside the Plonky2 circuit, and wires
the digests back to the requesting gadgets.

TPU-first shape: the accelerator is a standalone batched circuit proving N
fixed-length digests. Its constraint evaluation — the expensive part — runs
as one LDE-wide batched device kernel over all N compressions at once
(amortizing exactly like the reference's single AIR), and the requesting
circuit pays only (a) one recursive verification and (b) N cheap Poseidon
leaf recomputations to bind (message, digest) pairs to the accelerator's
public commitment root.

Commitment layout (shared by accelerator and consumer):
  leaf_i = Poseidon(msg_words_i ∥ digest_words_i)   (4-byte BE words)
  root   = binary Poseidon tree over leaves (zero-padded to pow2)
  accelerator public inputs = [root (4 felts)]

Counterpart of the reference's ``rollup/sha256_accelerator.py``, on the
port's circuit builder: the same rows; its proofs run on the build's
``device``.
"""

from __future__ import annotations

import dataclasses

from ..core import poseidon_host
from ..snark import recursion
from ..snark.circuit import CircuitBuilder, CircuitData
from ..snark.config import CircuitConfig
from ..snark import prover as snark_prover
from ..snark.prover import Proof
from ..snark.sha256 import Sha256Gadget, set_bytes_witness

P = (1 << 64) - (1 << 32) + 1


def _words_of_bytes(data: bytes) -> list[int]:
    assert len(data) % 4 == 0
    return [int.from_bytes(data[i:i + 4], "big")
            for i in range(0, len(data), 4)]


def commitment_root_host(pairs: list) -> list[int]:
    """pairs: [(message bytes, digest bytes)]; host twin of the in-circuit
    commitment."""
    leaves = [poseidon_host.hash_no_pad(_words_of_bytes(m) +
                                        _words_of_bytes(d))
              for m, d in pairs]
    n = 1
    while n < len(leaves):
        n <<= 1
    leaves += [[0, 0, 0, 0]] * (n - len(leaves))
    while len(leaves) > 1:
        leaves = [poseidon_host.two_to_one(leaves[i], leaves[i + 1])
                  for i in range(0, len(leaves), 2)]
    return leaves[0]


def _pad4(b: CircuitBuilder, targets: list) -> list:
    """Zero-pad byte targets to a multiple of 4 for u32 word packing (the
    commitment-leaf encoding of arbitrary-length messages; both the
    accelerator and every consumer MUST use this same padding)."""
    rem = (-len(targets)) % 4
    return list(targets) + [b.zero()] * rem


def _commit_root_gadget(b: CircuitBuilder, leaves: list) -> list:
    n = 1
    while n < len(leaves):
        n <<= 1
    z = b.zero()
    leaves = list(leaves) + [[z, z, z, z]] * (n - len(leaves))
    while len(leaves) > 1:
        leaves = [b.hash_two_to_one(leaves[i], leaves[i + 1])
                  for i in range(0, len(leaves), 2)]
    return leaves[0]


@dataclasses.dataclass
class Sha256AcceleratorCircuit:
    """Proves N sha256 digests of fixed-length messages; public inputs =
    the commitment root (ByteStark-with-Plonky2Air role)."""
    data: CircuitData
    msg_targets: list           # per message: list of byte targets
    digest_targets: list        # per message: 32 byte targets
    n_msgs: int
    msg_len: int

    @classmethod
    def build(cls, config: CircuitConfig, n_msgs: int, msg_len: int,
              double: bool = False, device=None
              ) -> "Sha256AcceleratorCircuit":
        return cls.build_multi(config, [(msg_len, double)] * n_msgs,
                               device=device)

    @classmethod
    def build_multi(cls, config: CircuitConfig, specs: list, device=None
                    ) -> "Sha256AcceleratorCircuit":
        """specs: [(msg_len, double)] per slot — mixed-length domains (the
        reference's planner pads all requests into one AIR; here each slot
        gets its own padded compression chain in the same batched
        circuit). The proofs run on `device` (CUDA unless ``"cpu"``)."""
        b = CircuitBuilder(config)
        g = Sha256Gadget(b)
        msg_targets, digest_targets, leaves = [], [], []
        for (msg_len, double) in specs:
            msg = b.add_virtual_targets(msg_len)
            dig = g.sha256d_bytes(msg) if double else g.sha256_bytes(msg)
            words_m = [w.target for w in
                       g.bytes_to_u32_words(_pad4(b, msg))]
            words_d = [w.target for w in g.bytes_to_u32_words(dig)]
            leaves.append(b.hash_n_to_hash_no_pad(words_m + words_d))
            msg_targets.append(msg)
            digest_targets.append(dig)
        root = _commit_root_gadget(b, leaves)
        b.register_public_inputs(root)
        data = b.build(device=device)
        return cls(data=data, msg_targets=msg_targets,
                   digest_targets=digest_targets, n_msgs=len(specs),
                   msg_len=specs[0][0] if specs else 0)

    def prove(self, messages: list) -> Proof:
        assert len(messages) == self.n_msgs
        pw = self.data._builder.partial_witness()
        for msg_t, msg in zip(self.msg_targets, messages):
            set_bytes_witness(pw, msg_t, msg)
        return snark_prover.prove(self.data, pw)


class Sha256DomainPlanner:
    """Collects sha256 requests from consumer-circuit builders and assigns
    accelerator slots (planner.rs Sha256AcceleratorDomainPlanner twin).
    All requests in one domain share a message length."""

    def __init__(self, msg_len: int, double: bool = False):
        self.msg_len = msg_len
        self.double = double
        self.requests: list = []         # (msg byte targets, digest targets)

    def request_digest(self, b: CircuitBuilder, msg_byte_targets: list
                       ) -> list:
        """Register a request; returns 32 *virtual* digest byte targets the
        consumer uses as if sha256 had been computed in-circuit."""
        assert len(msg_byte_targets) == self.msg_len
        digest = b.add_virtual_targets(32)
        self.requests.append((list(msg_byte_targets), digest))
        return digest

    def finalize(self, b: CircuitBuilder, accel_data: CircuitData):
        """Bind all requests: recompute the commitment root from the
        consumer's (msg, digest) targets, recursively verify the
        accelerator proof, connect roots. Returns the proof targets the
        witness must fill (smartgadget finalize role)."""
        g = Sha256Gadget(b)
        leaves = []
        for msg, dig in self.requests:
            for t in dig:
                b.range_check(t, 8)
            words_m = [w.target for w in g.bytes_to_u32_words(msg)]
            words_d = [w.target for w in g.bytes_to_u32_words(dig)]
            leaves.append(b.hash_n_to_hash_no_pad(words_m + words_d))
        root = _commit_root_gadget(b, leaves)
        pt = recursion.add_virtual_proof(b, accel_data.common)
        vdt = recursion.constant_verifier_data(b, accel_data.verifier)
        recursion.verify_proof_gadget(b, pt, accel_data.common, vdt)
        b.connect_hashes(pt.public_inputs[0:4], root)
        return pt

    def set_witness(self, pw, pt, accel_proof: Proof, messages: list,
                    digests: list):
        """Fill the accelerator proof + digest bytes on the consumer side."""
        recursion.set_proof_witness(pw, pt, accel_proof)
        for (_msg, dig_t), dig in zip(self.requests, digests):
            for t, v in zip(dig_t, dig):
                pw.set(t, v)
