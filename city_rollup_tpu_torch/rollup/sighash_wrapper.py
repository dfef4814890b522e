"""CRSigHashWrapperCircuit + CRSigHashFinalGLCircuit.

- Wrapper (sighash_wrapper.rs:62-128 twin): verifies ANY whitelisted
  sighash circuit proof: the inner verifier data is a witness whose
  fingerprint must be Merkle-included in the (constant) whitelist root
  (height-16 tree of admissible shapes,
  city_store/src/store/sighash/mod.rs:24-85). Re-exposes the inner public
  inputs [finalized_hash, sighash_felt252]. Since all sighash circuits are
  padded to one shared proof shape, one wrapper serves every shape.
  `SIGHASH_WHITELIST_DISABLED_DEV_MODE` skips the inclusion check
  (sighash_wrapper_config.rs:11).

- Final GL circuit (sighash_final_gl.rs:39-160 twin): verifies (block
  state transition proof, sighash wrapper proof) with constant verifier
  data, recomputes the introspection finalized hash from its components
  and connects the rollup state roots, producing the final Goldilocks
  proof per tx input (the one the Groth16 stage wraps).

Counterpart of the reference's ``rollup/sighash_wrapper.py``, on the
port's circuit builder; both circuits are built for one ``device``.
"""

from __future__ import annotations

import dataclasses

from ..snark import recursion
from ..snark.circuit import CircuitBuilder, CircuitData
from ..snark.config import CircuitConfig
from ..snark import prover as snark_prover
from ..snark.prover import Proof
from ..snark.gadgets import select_base, split_le_16
from .sighash_tree import (SIGHASH_WHITELIST_DISABLED_DEV_MODE,
                           SigHashMerkleTree)

P = (1 << 64) - (1 << 32) + 1


def _merkle_walk_gadget(b: CircuitBuilder, leaf: list, index_bits: list,
                        siblings: list) -> list:
    cur = list(leaf)
    for bit, sib in zip(index_bits, siblings):
        left = [select_base(b, bit, sib[j], cur[j]) for j in range(4)]
        right = [select_base(b, bit, cur[j], sib[j]) for j in range(4)]
        cur = b.hash_two_to_one(left, right)
    return cur


@dataclasses.dataclass
class SigHashWrapperCircuit:
    data: CircuitData
    targets: dict
    whitelist: SigHashMerkleTree
    inner_common: object

    @classmethod
    def build(cls, config: CircuitConfig, inner_common,
              whitelist: SigHashMerkleTree, device=None
              ) -> "SigHashWrapperCircuit":
        """Its proofs run on `device` (CUDA unless ``"cpu"``)."""
        b = CircuitBuilder(config)
        pt = recursion.add_virtual_proof(b, inner_common)
        vdt = recursion.add_virtual_verifier_data(b, inner_common)
        fp = recursion.fingerprint_gadget(b, vdt)
        height = whitelist.height

        index_bits = []
        siblings = [b.add_virtual_hash() for _ in range(height)]
        for _ in range(height):
            t = b.add_virtual_target()
            b.assert_zero(b.mul(t, b.add_const(t, P - 1)))
            index_bits.append(t)
        if not SIGHASH_WHITELIST_DISABLED_DEV_MODE:
            root = _merkle_walk_gadget(b, fp, index_bits, siblings)
            for j in range(4):
                b.connect(root[j], b.constant(int(whitelist.root[j])))
        recursion.verify_proof_gadget(b, pt, inner_common, vdt)
        b.register_public_inputs(list(pt.public_inputs))
        data = b.build(device=device)
        return cls(data=data, whitelist=whitelist, inner_common=inner_common,
                   targets={"pt": pt, "vdt": vdt, "index_bits": index_bits,
                            "siblings": siblings})

    def prove(self, inner_proof: Proof, inner_verifier,
              fingerprint) -> Proof:
        t = self.targets
        pw = self.data._builder.partial_witness()
        recursion.set_proof_witness(pw, t["pt"], inner_proof)
        recursion.set_verifier_data_witness(pw, t["vdt"], inner_verifier)
        idx = self.whitelist.index_of(fingerprint)
        mproof = self.whitelist.prove(idx)
        for i, bit_t in enumerate(t["index_bits"]):
            pw.set(bit_t, (idx >> i) & 1)
        for sib_t, sib in zip(t["siblings"], mproof.siblings):
            for tt, v in zip(sib_t, sib):
                pw.set(tt, int(v))
        return snark_prover.prove(self.data, pw)


@dataclasses.dataclass
class SigHashFinalGLCircuit:
    """Final per-tx-input proof: binds the introspection result to the
    rollup's state transition IN-CIRCUIT (sighash_final_gl.rs:39-160 twin).

    The block transition proof exposes
    ``[old_city_root(4), new_city_root(4), wd_events(4), dep_events(4)]``
    (op_circuits.make_block_transition); the sighash wrapper proof exposes
    ``[finalized_hash(4), sighash_felt252(4)]``. This circuit recomputes the
    finalized introspection hash with every component CONSTRAINED to the
    transition proof: the covenant state hashes are the felt248 packings of
    the actual old/new city roots (felt248_of_hashout, the twin of
    felthash248.rs connect_full_hashout_to_felt248_hashout), and the
    deposit/withdrawal event roots are the transition proof's own event
    hashes. Only the balances and spend index remain free witnesses (they
    are bound to the L1 tx bytes by the sighash circuit itself).

    Public inputs: [cur_state_felt248(4), sighash_felt252(4)] — the pair
    the Groth16 wrap attests to (reference exposes the same data as bits
    for gnark; we keep felts and let the wrap statement define its own
    encoding)."""
    data: CircuitData
    targets: dict

    @classmethod
    def build(cls, config: CircuitConfig, transition_data: CircuitData,
              wrapper_data: CircuitData, device=None
              ) -> "SigHashFinalGLCircuit":
        """Its proofs run on `device` (CUDA unless ``"cpu"``); the two
        verifier data it holds as constants are the inner circuits'
        preprocessing, on their own devices."""
        from .sighash_circuit import felt248_of_hashout
        b = CircuitBuilder(config)

        # verify both proofs under constant verifier data
        pt_tr = recursion.add_virtual_proof(b, transition_data.common)
        vdt_tr = recursion.constant_verifier_data(b,
                                                  transition_data.verifier)
        recursion.verify_proof_gadget(b, pt_tr, transition_data.common,
                                      vdt_tr)
        pt_w = recursion.add_virtual_proof(b, wrapper_data.common)
        vdt_w = recursion.constant_verifier_data(b, wrapper_data.verifier)
        recursion.verify_proof_gadget(b, pt_w, wrapper_data.common, vdt_w)

        old_root = list(pt_tr.public_inputs[0:4])
        new_root = list(pt_tr.public_inputs[4:8])
        wd_events = list(pt_tr.public_inputs[8:12])
        dep_events = list(pt_tr.public_inputs[12:16])

        # covenant state hashes = felt248 packing of the proven city roots
        cur_state = felt248_of_hashout(b, old_root)
        next_state = felt248_of_hashout(b, new_root)

        # balances + spend index stay witnesses (tx-byte-bound inside the
        # sighash circuit via the finalized hash)
        cur_bal = b.add_virtual_target()
        next_bal = b.add_virtual_target()
        spend_idx = b.add_virtual_target()

        # recompute the finalized introspection hash — component order must
        # match SigHashCircuit.build (dep, wd, cur, next, balances, idx)
        finalized = b.hash_n_to_hash_no_pad(
            dep_events + wd_events + cur_state + next_state +
            [cur_bal, next_bal, spend_idx])
        b.connect_hashes(finalized, pt_w.public_inputs[0:4])

        b.register_public_inputs(list(cur_state))
        b.register_public_inputs(list(pt_w.public_inputs[4:8]))
        data = b.build(device=device)
        return cls(data=data, targets={
            "pt_tr": pt_tr, "pt_w": pt_w, "cur_bal": cur_bal,
            "next_bal": next_bal, "spend_idx": spend_idx})

    def prove(self, transition_proof: Proof, wrapper_proof: Proof,
              components: dict) -> Proof:
        """components: cur_bal/next_bal/spend_idx ints (everything else is
        derived in-circuit from the two proofs)."""
        t = self.targets
        pw = self.data._builder.partial_witness()
        recursion.set_proof_witness(pw, t["pt_tr"], transition_proof)
        recursion.set_proof_witness(pw, t["pt_w"], wrapper_proof)
        for name in ("cur_bal", "next_bal", "spend_idx"):
            pw.set(t[name], int(components[name]))
        return snark_prover.prove(self.data, pw)
