"""ZK signature circuits: the rollup's L2 signature scheme.

An L2 "signature" is a proof of knowledge of a hash-preimage private key:
pk = Poseidon(DOMAIN, sk) and the proof binds (pk, action_hash) as public
inputs. Op circuits verify a *wrapper* proof (fixed wrapper fingerprint)
rather than the inner proof directly, so the inner circuit can evolve
without changing the op-circuit shapes.

Reference roles:
- inner circuit: city_common_circuit/src/circuits/zk_signature/inner.rs
  (pk = Poseidon(constants ^ sk) in a blinded recursion config);
- wrapper: city_common_circuit/src/circuits/zk_signature_wrapper/ —
  `ZKSignatureWrapperCircuit` verifies any such proof and is the leaf
  verified inside op circuits (SURVEY.md §2.2 "ZK signature circuits");
- the wrap itself rides the proof minifier (pm_core.rs), see
  snark/minifier.py.

Public-input layout of both inner and wrapper proofs:
    [pk (4 felts), action_hash (4 felts)]

Counterpart of the reference's ``rollup/zk_signature.py``, on the port's
prover; the circuits are built for one ``device``.
"""

from __future__ import annotations

import dataclasses

from ..core import poseidon_host
from ..snark import recursion
from ..snark.circuit import CircuitBuilder, CircuitData, PartialWitness
from ..snark.config import CircuitConfig
from ..snark.minifier import ProofMinifier
from ..snark import prover as snark_prover
from ..snark.prover import Proof

# domain-separation constant for key derivation ("ZKSIG" in ASCII)
ZK_SIG_DOMAIN = 0x5A4B534947


def derive_public_key(sk: list[int]) -> list[int]:
    """Host twin of the in-circuit key derivation: pk = Poseidon(DOMAIN, sk)."""
    assert len(sk) == 4
    return poseidon_host.hash_no_pad([ZK_SIG_DOMAIN] + [int(x) for x in sk])


@dataclasses.dataclass
class ZKSignatureInnerCircuit:
    """Proves knowledge of sk with pk = Poseidon(DOMAIN, sk); binds an
    arbitrary action hash (the signed message commitment)."""
    data: CircuitData
    sk_targets: list
    action_targets: list

    @classmethod
    def build(cls, config: CircuitConfig, device=None
              ) -> "ZKSignatureInnerCircuit":
        """Built in the zk (blinded) variant of `config` — the openings of
        a signature proof must not leak sk (reference uses
        standard_recursion_zk_config here, zk_signature/inner.rs:50; our zk
        mode: CircuitConfig.num_blinding_rows). Its proofs run on `device`
        (CUDA unless ``"cpu"``)."""
        import dataclasses as _dc
        if not config.zk:
            config = _dc.replace(config, zk=True)
        b = CircuitBuilder(config)
        sk = b.add_virtual_targets(4)
        action = b.add_virtual_hash()
        pk = b.hash_n_to_hash_no_pad([b.constant(ZK_SIG_DOMAIN)] + sk)
        b.register_public_inputs(pk)
        b.register_public_inputs(action)
        data = b.build(device=device)
        return cls(data=data, sk_targets=sk, action_targets=action)

    def sign(self, sk: list[int], action_hash: list[int]) -> Proof:
        pw = self.data._builder.partial_witness()
        for t, v in zip(self.sk_targets, sk):
            pw.set(t, int(v))
        for t, v in zip(self.action_targets, action_hash):
            pw.set(t, int(v))
        return snark_prover.prove(self.data, pw)


@dataclasses.dataclass
class ZKSignatureWrapperCircuit:
    """Verifies an inner signature proof under the fixed inner verifier data
    and re-exposes [pk, action] — the circuit whose fingerprint op circuits
    pin (zk_signature_wrapper twin). Implemented as one minifier step."""
    inner: ZKSignatureInnerCircuit
    minifier: ProofMinifier

    @classmethod
    def build(cls, config: CircuitConfig,
              inner: ZKSignatureInnerCircuit | None = None, device=None
              ) -> "ZKSignatureWrapperCircuit":
        """Both circuits on `device` (CUDA unless ``"cpu"``)."""
        inner = inner or ZKSignatureInnerCircuit.build(config, device=device)
        step = ProofMinifier.build(inner.data, config, device=device)
        return cls(inner=inner, minifier=step)

    @property
    def data(self) -> CircuitData:
        return self.minifier.data

    @property
    def fingerprint(self) -> tuple:
        return self.minifier.fingerprint

    def sign(self, sk: list[int], action_hash: list[int]) -> Proof:
        return self.minifier.prove(self.inner.sign(sk, action_hash))

    def verify(self, proof: Proof) -> bool:
        from ..snark import verifier as snark_verifier
        return snark_verifier.verify(proof, self.data.common,
                                     self.data.verifier)


@dataclasses.dataclass
class FixedPublicKeyZKSignatureCircuit:
    """Variant pinning one specific pk as a circuit constant
    (zk_signature/fixed_public_key.rs twin): the proof shows knowledge of
    THAT key's preimage; only the action hash is a free public input."""
    data: CircuitData
    sk_targets: list
    action_targets: list
    public_key: tuple

    @classmethod
    def build(cls, config: CircuitConfig, public_key: list[int],
              device=None) -> "FixedPublicKeyZKSignatureCircuit":
        """Its proofs run on `device` (CUDA unless ``"cpu"``)."""
        b = CircuitBuilder(config)
        sk = b.add_virtual_targets(4)
        action = b.add_virtual_hash()
        pk = b.hash_n_to_hash_no_pad([b.constant(ZK_SIG_DOMAIN)] + sk)
        for j in range(4):
            b.connect(pk[j], b.constant(int(public_key[j])))
        b.register_public_inputs([b.constant(int(v)) for v in public_key])
        b.register_public_inputs(action)
        data = b.build(device=device)
        return cls(data=data, sk_targets=sk, action_targets=action,
                   public_key=tuple(int(v) for v in public_key))

    def sign(self, sk: list[int], action_hash: list[int]) -> Proof:
        pw = self.data._builder.partial_witness()
        for t, v in zip(self.sk_targets, sk):
            pw.set(t, int(v))
        for t, v in zip(self.action_targets, action_hash):
            pw.set(t, int(v))
        return snark_prover.prove(self.data, pw)
