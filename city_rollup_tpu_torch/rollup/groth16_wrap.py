"""Groth16 wrap statement for the final-GL sighash proof.

Reference role: `gnark-plonky2-wrapper` as consumed at
city_rollup_circuit/src/worker/toolbox/root.rs:256-318 — the last hop of the
proving chain: per tx input, the final Goldilocks proof (public inputs
[cur_state_felt248(4), sighash_felt252(4)], rollup/sighash_wrapper.py) is
wrapped into a Groth16 proof over BLS12-381 that a patched Dogecoin node
checks on-chain via OP_CHECKGROTH16VERIFY against the covenant script's
embedded state hash + the transaction sighash.

Statement design (pragmatic tier, as planned in VERDICT r3 item 3): the R1CS
proves knowledge of 8 range-checked Goldilocks felts that
  (a) pack to the two public Fr field elements
      x_state   = sum pis[0..4) * 2^(62 i)     (the felt248 state hash)
      x_sighash = sum pis[4..8) * 2^(63 i)     (the felt252 sighash)
  (b) MiMC-sponge (x^5 Feistel over Fr, the in-R1CS-native hash — same
      pattern as gnark's in-circuit PI compression) together with the
      final-GL circuit FINGERPRINT (a baked constant of the statement) to
      the third public input `digest`.
The worker fully verifies the final-GL proof with the Goldilocks verifier
BEFORE wrapping (snark/verifier.py — FRI and all), so the Groth16 proof
attests to the packed public inputs of a worker-verified proof under a
pinned circuit fingerprint. The upgrade path to full on-chain soundness is
encoding that Goldilocks verifier itself in R1CS (what gnark-plonky2-wrapper
does with ~2M constraints); the statement, key plumbing, proof-data format
and job flow here are unchanged by that swap.

`GROTH16_DISABLED_DEV_MODE` mirrors block_template/config.rs:7 — when True
the wrap returns a zeroed CityGroth16ProofData and the covenant's
OP_CHECKGROTH16VERIFY becomes OP_NOP (btc.py).

Counterpart of the reference's ``rollup/groth16_wrap.py``: a copy, with
one repair. The reference's ``wrap_final_proof`` calls the Goldilocks
verifier as ``verify(final_data, final_proof)``, which raises a
TypeError (it takes the proof, the common data and the verifier data)
and would not raise on a rejected proof (it returns a bool). Here it is
called as ``verify(proof, data.common, data.verifier)``, and a rejected
proof raises ValueError before any Groth16 work.
"""

from __future__ import annotations

import dataclasses
import hashlib

from ..crypto import groth16
from ..crypto.groth16 import R1CS, Groth16Proof
from ..crypto.bls12_381 import R as FR

GROTH16_DISABLED_DEV_MODE = False

# The current wrap statement attests to the packed public inputs of a
# WORKER-verified final-GL proof under a pinned fingerprint — it does NOT
# re-verify the Goldilocks proof inside R1CS, so on-chain it proves nothing
# by itself (anyone can satisfy it for arbitrary inputs). Until the
# in-R1CS Goldilocks verifier lands, broadcasting a covenant spend that
# RELIES on OP_CHECKGROTH16VERIFY is unsound; the L1-broadcast path
# (Orchestrator.assemble_l1_transaction with a live link) therefore
# refuses to run unless this dev-mode flag is explicitly set, mirroring
# GROTH16_DISABLED_DEV_MODE (block_template/config.rs:7).
GROTH16_WRAP_ATTESTATION_DEV_MODE = False

# MiMC-Feistel x^5 over Fr: 220 rounds (2x ceil(log5 2^255) for the Feistel
# structure), nothing-up-my-sleeve constants.
MIMC_ROUNDS = 220
assert pow(5, -1, FR - 1) is not None   # gcd(5, r-1) == 1 -> x^5 bijective
MIMC_CONSTANTS = [
    int.from_bytes(hashlib.sha256(b"city-rollup-mimc-%d" % i).digest(),
                   "big") % FR
    for i in range(MIMC_ROUNDS)
]


def mimc_permute(left: int, right: int) -> tuple[int, int]:
    """Host twin of the in-R1CS Feistel permutation."""
    for c in MIMC_CONSTANTS:
        t = (left + c) % FR
        left, right = (right + pow(t, 5, FR)) % FR, left
    return left, right


def mimc_sponge(inputs: list[int]) -> int:
    """Absorb-each-then-permute sponge; digest = final left lane."""
    left, right = 0, 0
    for m in inputs:
        left = (left + m) % FR
        left, right = mimc_permute(left, right)
    return left


def pack_state(pis: list[int]) -> tuple[int, int]:
    """(x_state, x_sighash) packings of the final-GL proof's 8 public
    inputs (4 x 62-bit felt248 limbs, 4 x 63-bit felt252 limbs)."""
    assert len(pis) == 8
    x_state = sum(int(pis[i]) << (62 * i) for i in range(4))
    x_sighash = sum(int(pis[4 + i]) << (63 * i) for i in range(4))
    return x_state % FR, x_sighash % FR


def binding_digest(pis: list[int], fingerprint) -> int:
    """The wrap statement's digest: MiMC sponge over the packed public
    inputs and the final-GL circuit fingerprint (4 GL felts packed as two
    128-bit Fr values)."""
    x_state, x_sighash = pack_state(pis)
    fp = [int(x) for x in fingerprint]
    fp_lo = fp[0] | (fp[1] << 64)
    fp_hi = fp[2] | (fp[3] << 64)
    return mimc_sponge([x_state, x_sighash, fp_lo, fp_hi])


# ---------------------------------------------------------------------------
# R1CS construction
# ---------------------------------------------------------------------------

class _LC(dict):
    """Sparse linear combination {var_index: coeff}; index 0 is the
    constant-one variable."""

    def plus(self, other: "_LC") -> "_LC":
        out = _LC(self)
        for k, v in other.items():
            out[k] = (out.get(k, 0) + v) % FR
        return out

    def plus_const(self, c: int) -> "_LC":
        out = _LC(self)
        out[0] = (out.get(0, 0) + c) % FR
        return out

    @staticmethod
    def var(i: int, coeff: int = 1) -> "_LC":
        return _LC({i: coeff % FR})


class _Builder:
    """Minimal R1CS builder: public vars first, then privates; each private
    var carries a generator fn(w)->value evaluated in allocation order."""

    def __init__(self, num_public: int):
        self.num_public = num_public
        self.nv = 1 + num_public
        self.gens: list = []            # (var_idx, fn)
        self.a_rows: list = []
        self.b_rows: list = []
        self.c_rows: list = []

    def alloc(self, fn) -> int:
        idx = self.nv
        self.nv += 1
        self.gens.append((idx, fn))
        return idx

    def enforce(self, a: _LC, b: _LC, c: _LC):
        self.a_rows.append(dict(a))
        self.b_rows.append(dict(b))
        self.c_rows.append(dict(c))

    def _eval(self, lc: _LC, w: list) -> int:
        return sum(coeff * w[i] for i, coeff in lc.items()) % FR

    def mul(self, a: _LC, b: _LC) -> _LC:
        idx = self.alloc(lambda w, _a=a, _b=b:
                         self._eval(_a, w) * self._eval(_b, w) % FR)
        self.enforce(a, b, _LC.var(idx))
        return _LC.var(idx)

    def bits(self, lc: _LC, n: int) -> list[_LC]:
        """Decompose lc into n boolean vars; enforces the recomposition,
        bounding the value to [0, 2^n)."""
        bit_lcs = []
        recomb = _LC()
        for j in range(n):
            idx = self.alloc(lambda w, _lc=lc, _j=j:
                             (self._eval(_lc, w) >> _j) & 1)
            bv = _LC.var(idx)
            self.enforce(bv, bv.plus_const(FR - 1), _LC())      # b(b-1)=0
            recomb = recomb.plus(_LC.var(idx, pow(2, j, FR)))
            bit_lcs.append(bv)
        self.enforce(recomb.plus(_LC({i: FR - c for i, c in lc.items()})),
                     _LC.var(0), _LC())
        return bit_lcs

    def finish(self) -> R1CS:
        return R1CS(num_public=self.num_public, num_vars=self.nv,
                    a_rows=self.a_rows, b_rows=self.b_rows,
                    c_rows=self.c_rows)


def _mimc_sponge_r1cs(b: _Builder, inputs: list[_LC]) -> _LC:
    left, right = _LC(), _LC()
    for m in inputs:
        left = left.plus(m)
        for c in MIMC_CONSTANTS:
            t = left.plus_const(c)
            t2 = b.mul(t, t)
            t4 = b.mul(t2, t2)
            t5 = b.mul(t4, t)
            left, right = right.plus(t5), left
    return left


@dataclasses.dataclass
class Groth16WrapCircuit:
    """The wrap statement specialized to one final-GL circuit fingerprint.
    Public inputs: [x_state, x_sighash, digest]."""
    r1cs: R1CS
    fingerprint: tuple
    pk: object = None
    vk: object = None

    VAR_PIS0 = 4                   # first private var (after 1 + 3 publics)

    @classmethod
    def build(cls, fingerprint, *, setup_seed: bytes | None = None,
              dev_deterministic: bool = False) -> "Groth16WrapCircuit":
        b = _Builder(num_public=3)
        x_state, x_sighash, digest = (_LC.var(1), _LC.var(2), _LC.var(3))

        # 8 private felt vars (allocated first so witness layout is stable)
        pi_vars = [b.alloc(lambda w, _i=i: w[cls.VAR_PIS0 + _i])
                   for i in range(8)]
        pis = [_LC.var(v) for v in pi_vars]

        # range checks + packing
        packed_state = _LC()
        for i in range(4):
            b.bits(pis[i], 62)
            packed_state = packed_state.plus(
                _LC.var(pi_vars[i], pow(2, 62 * i, FR)))
        packed_sighash = _LC()
        for i in range(4):
            b.bits(pis[4 + i], 63)
            packed_sighash = packed_sighash.plus(
                _LC.var(pi_vars[4 + i], pow(2, 63 * i, FR)))
        b.enforce(packed_state.plus(_LC({1: FR - 1})), _LC.var(0), _LC())
        b.enforce(packed_sighash.plus(_LC({2: FR - 1})), _LC.var(0), _LC())

        # binding digest with the baked fingerprint constants
        fp = [int(x) for x in fingerprint]
        fp_lo = (fp[0] | (fp[1] << 64)) % FR
        fp_hi = (fp[2] | (fp[3] << 64)) % FR
        d = _mimc_sponge_r1cs(b, [x_state, x_sighash,
                                  _LC({0: fp_lo}), _LC({0: fp_hi})])
        b.enforce(d.plus(_LC({3: FR - 1})), _LC.var(0), _LC())

        r1cs = b.finish()
        out = cls(r1cs=r1cs, fingerprint=tuple(fp))
        out._builder = b
        out.pk, out.vk = groth16.setup(r1cs, setup_seed,
                                       dev_deterministic=dev_deterministic)
        return out

    # -- witness -------------------------------------------------------------
    def _witness(self, pis: list[int]) -> list:
        x_state, x_sighash = pack_state(pis)
        digest = binding_digest(pis, self.fingerprint)
        w = [1, x_state, x_sighash, digest] + [0] * (self.r1cs.num_vars - 4)
        for i in range(8):
            w[self.VAR_PIS0 + i] = int(pis[i]) % FR
        b = self._builder
        for idx, fn in b.gens:
            if w[idx] == 0:
                w[idx] = fn(w)
        assert self.r1cs.is_satisfied(w), "wrap witness unsatisfied"
        return w

    def prove(self, pis: list[int], rand_seed: bytes | None = None
              ) -> tuple[Groth16Proof, list[int]]:
        """Returns (proof, public_inputs [x_state, x_sighash, digest])."""
        w = self._witness([int(x) for x in pis])
        proof = groth16.prove(self.pk, w, rand_seed)
        return proof, w[1:4]

    def verify(self, proof: Groth16Proof, public_inputs: list[int]) -> bool:
        return groth16.verify(self.vk, public_inputs, proof)


def wrap_final_proof(wrap_circuit: Groth16WrapCircuit, final_data,
                     final_proof) -> dict:
    """Full wrap step (root.rs:256-318 twin): verify the final-GL proof
    with the Goldilocks verifier, then produce CityGroth16ProofData.

    Returns {"proof_data": 192-byte-format dict, "public_inputs": [...],
    "proof": Groth16Proof} or a zeroed proof in dev mode."""
    if GROTH16_DISABLED_DEV_MODE:
        zero = "00" * 48
        return {"proof_data": {"pi_a": zero, "pi_b_a0": zero,
                               "pi_b_a1": zero, "pi_c": zero},
                "public_inputs": [], "proof": None}
    from ..snark import verifier as gl_verifier
    if not gl_verifier.verify(final_proof, final_data.common,
                              final_data.verifier):
        raise ValueError("the final-GL proof does not verify")
    proof, pub = wrap_circuit.prove(list(final_proof.public_inputs))
    assert wrap_circuit.verify(proof, pub)
    return {"proof_data": proof.to_city_data(), "public_inputs": pub,
            "proof": proof}
