"""L1 (secp256k1 ECDSA) signature proof circuit: proves knowledge of a
valid ECDSA signature on a message under a public key, exposing only
`combined = Poseidon(pk.x felts, y parity, msg felts)` as public input —
the shape the claim-deposit op pins.

Reference role: `Secp256K1SignatureCircuit`
(city_common_circuit/src/crypto/secp256k1/signature_circuit.rs:40-60 —
built in the ecc config then minified twice to the standard shape; here the
ECDSA circuit already lives in the standard config, and an optional
minifier chain normalizes the proof for recursion).

Counterpart of the reference's ``rollup/l1_signature.py``, on the port's
circuit builder; the circuits are built for one ``device``.
"""

from __future__ import annotations

import dataclasses

from ..crypto import secp256k1 as secp
from ..snark.circuit import CircuitBuilder, CircuitData
from ..snark.config import CircuitConfig
from ..snark.minifier import MinifierChain
from ..snark import prover as snark_prover
from ..snark.prover import Proof
from ..snark.secp_gadgets import SecpGadget
from ..snark.gadgets import split_le_16


def compressed_pk_felts(b: CircuitBuilder, g: SecpGadget, pk_point) -> list:
    """9-felt packing of the 33-byte compressed pubkey (prefix 02/03 ∥
    x big-endian), matching felts.bytes33_to_felts — the SAME packing the
    deposit leaf and the sighash circuit use, so one pk value flows through
    every layer. In-circuit: split each 16-bit x limb into (hi, lo) bytes,
    derive the parity prefix from y's low limb, regroup as 4-byte LE
    felts."""
    # y parity: y_limb0 = 2*half + bit
    half = b.add_virtual_target()
    bit = b.add_virtual_target()
    y0 = pk_point.y.limbs[0]

    def gen(pw, _y0=y0, _h=half, _b=bit):
        v = pw.get(_y0)
        if v is None:
            return
        pw.set(_b, v & 1)
        pw.set(_h, v >> 1)

    b.add_generator(gen, deps=[y0])
    b.assert_zero(b.mul(bit, b.add_const(bit, (1 << 64) - (1 << 32))))
    b.range_check(half, 15)
    b.connect(b.arithmetic(2, 1, half, b.one(), bit), y0)

    # byte-split the 16 x limbs (LE): limb_k = hi_k*256 + lo_k
    lo = b.add_virtual_targets(16)
    hi = b.add_virtual_targets(16)
    for k in range(16):
        limb = pk_point.x.limbs[k]

        def bgen(pw, _l=limb, _lo=lo[k], _hi=hi[k]):
            v = pw.get(_l)
            if v is None:
                return
            pw.set(_lo, v & 0xFF)
            pw.set(_hi, v >> 8)

        b.add_generator(bgen, deps=[limb])
        b.range_check(lo[k], 8)
        b.range_check(hi[k], 8)
        b.connect(b.arithmetic(256, 1, hi[k], b.one(), lo[k]), limb)

    # compressed bytes: [2 + parity] ∥ x BE; x BE byte j = x LE byte 31-j
    le_bytes = []
    for k in range(16):
        le_bytes.extend([lo[k], hi[k]])
    prefix = b.add_const(bit, 2)
    comp = [prefix] + [le_bytes[31 - j] for j in range(32)]
    # 9 felts of 4 LE bytes (last felt = 1 byte)
    felts = []
    for i in range(9):
        chunk = comp[4 * i:4 * i + 4]
        acc = b.zero()
        for j, t in enumerate(chunk):
            acc = b.arithmetic(1 << (8 * j), 1, t, b.one(), acc)
        felts.append(acc)
    return felts


def combined_hash_gadget(b: CircuitBuilder, g: SecpGadget, pk_point,
                         msg_biguint) -> list:
    """In-circuit twin of crypto.secp256k1.combined_action_hash:
    Poseidon(pk9 ∥ msg as 4x64-bit LE felts). The msg felts equal the
    claim op's action digest when msg = a0|a1<<64|a2<<128|a3<<192 (the
    wallet's signing convention). Note the 64-bit groups are taken mod p
    when hashed; a prover holding the key could shift a group by p, which
    buys nothing (they can sign the canonical message directly)."""
    pk9 = compressed_pk_felts(b, g, pk_point)
    msg4 = g.big.pack_felts(msg_biguint, 64)
    return b.hash_n_to_hash_no_pad(pk9 + msg4)


@dataclasses.dataclass
class Secp256K1SignatureCircuit:
    """ECDSA verify in-circuit; public inputs = combined hash (4 felts)."""
    data: CircuitData
    targets: dict

    @classmethod
    def build(cls, config: CircuitConfig, device=None
              ) -> "Secp256K1SignatureCircuit":
        """Its proofs run on `device` (CUDA unless ``"cpu"``)."""
        b = CircuitBuilder(config)
        g = SecpGadget(b)
        pk = g.add_virtual_point()
        msg = g.big.add_virtual_biguint(16)
        r = g.big.add_virtual_biguint(16)
        s = g.big.add_virtual_biguint(16)
        g.ecdsa_verify(pk, msg, r, s)
        combined = combined_hash_gadget(b, g, pk, msg)
        b.register_public_inputs(combined)
        data = b.build(device=device)
        return cls(data=data,
                   targets={"g": g, "pk": pk, "msg": msg, "r": r, "s": s})

    def fill_witness(self, pw, pk: secp.ECDSAPublicKey, msg_hash: int,
                     sig: secp.ECDSASignature):
        t = self.targets
        g: SecpGadget = t["g"]
        g.set_point(pw, t["pk"], pk.point)
        g.big.set_biguint(pw, t["msg"], msg_hash % (1 << 256))
        g.big.set_biguint(pw, t["r"], sig.r)
        g.big.set_biguint(pw, t["s"], sig.s)

    def prove(self, pk: secp.ECDSAPublicKey, msg_hash: int,
              sig: secp.ECDSASignature) -> Proof:
        pw = self.data._builder.partial_witness()
        self.fill_witness(pw, pk, msg_hash, sig)
        return snark_prover.prove(self.data, pw)


@dataclasses.dataclass
class L1DevSignatureCircuit:
    """DEV-MODE stand-in for the full ECDSA circuit: witnesses (pk, msg),
    checks pk lies on secp256k1, and exposes the SAME public-input
    contract — combined = Poseidon(pk9 ∥ msg4) — WITHOUT the ECDSA
    verification equation. It exists because the real GLV circuit builds
    at 2^22 rows (the hinted-complete addition law costs ~1k rows per
    point op; the reference stays ~2^17 via dedicated nonnative-mul and
    range gates, the planned next step), past what one prove can hold.
    The claim-deposit integration (witness plumbing, pk packing, action
    binding, recursive verification, aggregation) is identical either
    way; tests/test_secp_circuit.py and tests/test_torch_signature.py
    witness-validate the real circuit. NEVER deploy params.l1_sig_circuit
    built from this."""
    data: CircuitData
    targets: dict

    @classmethod
    def build(cls, config: CircuitConfig, device=None
              ) -> "L1DevSignatureCircuit":
        """Its proofs run on `device` (CUDA unless ``"cpu"``)."""
        b = CircuitBuilder(config)
        g = SecpGadget(b)
        pk = g.add_virtual_point()
        msg = g.big.add_virtual_biguint(16)
        g.assert_on_curve(pk)
        b.assert_zero(pk.is_inf)
        combined = combined_hash_gadget(b, g, pk, msg)
        b.register_public_inputs(combined)
        data = b.build(device=device)
        return cls(data=data, targets={"g": g, "pk": pk, "msg": msg})

    def prove(self, pk: secp.ECDSAPublicKey, msg_hash: int) -> Proof:
        t = self.targets
        g: SecpGadget = t["g"]
        pw = self.data._builder.partial_witness()
        g.set_point(pw, t["pk"], pk.point)
        g.big.set_biguint(pw, t["msg"], msg_hash % (1 << 256))
        return snark_prover.prove(self.data, pw)


@dataclasses.dataclass
class Secp256K1ProverChain:
    """Signature circuit + minifier chain to the standard recursion shape
    (the reference minifies the ecc-config proof twice,
    signature_circuit.rs:40-60)."""
    circuit: Secp256K1SignatureCircuit
    chain: MinifierChain

    @classmethod
    def build(cls, config: CircuitConfig, n_minify: int = 1, device=None
              ) -> "Secp256K1ProverChain":
        circ = Secp256K1SignatureCircuit.build(config, device=device)
        chain = MinifierChain.build(circ.data, n_minify, config,
                                    device=device)
        return cls(circuit=circ, chain=chain)

    @property
    def data(self) -> CircuitData:
        return self.chain.data

    def prove(self, pk, msg_hash, sig) -> Proof:
        return self.chain.prove(self.circuit.prove(pk, msg_hash, sig))
