"""Sighash proving toolbox: per-shape introspection circuits normalized to
ONE shared minified proof shape, the whitelist tree over their fingerprints,
the wrapper + final-GL circuits, and the Groth16 wrap.

Reference roles:
- per-config circuit cache + shared shape:
  city_rollup_circuit/src/sighash_circuits/sighash_wrapper.rs:58,129-160
  (every admissible shape minified to one CommonData so a single wrapper
  serves all 1,875 shapes);
- 3-stage minifier chain: sighash.rs:114-118 (one stage suffices here — the
  minifier already lands on the standard recursion shape);
- whitelist: city_rollup_common/src/config/sighash_wrapper_config.rs:24 +
  city_store/src/store/sighash/mod.rs:24-85;
- final GL + Groth16 wrap: sighash_final_gl.rs:39-160 and
  worker/toolbox/root.rs:256-318.

The shared shape is found with the same fixpoint used by
op_circuits.build_shape_family: probe-build each shape's minifier, take the
union gate set + max degree, rebuild with a declared gate set + min_log_n,
and assert every shape lands on the identical CommonData.

Counterpart of the reference's ``rollup/sighash_toolbox.py``, on the
port's prover: every circuit is built for one ``device``. The Groth16
wrap (``with_groth16``, ``wrap_groth16``) is host work (python ints), as
in the reference.
"""

from __future__ import annotations

import dataclasses

from ..snark.circuit import common_shape_key
from ..snark.config import CircuitConfig
from ..snark.minifier import ProofMinifier
from ..snark.prover import Proof
from ..snark.recursion import fingerprint_verifier_data
from . import btc
from .sighash_circuit import SigHashCircuit, SigHashShape
from .sighash_tree import SigHashMerkleTree
from .sighash_wrapper import SigHashFinalGLCircuit, SigHashWrapperCircuit


def _gid_from_felt(felt: int) -> btc.SigHashGadgetId:
    return btc.SigHashGadgetId(
        last_block_num_deposits=felt & 0xFF,
        last_block_num_withdrawals=(felt >> 8) & 0xFF,
        num_deposits=(felt >> 16) & 0xFF,
        num_withdrawals=(felt >> 24) & 0xFF,
        current_spend_index=(felt >> 32) & 0xFF)


@dataclasses.dataclass
class BuiltSigHashShape:
    gid: btc.SigHashGadgetId
    circuit: SigHashCircuit
    minifier: ProofMinifier

    @property
    def fingerprint(self) -> tuple:
        return self.minifier.fingerprint


class SigHashToolbox:
    """Builds the whole sighash side of the worker toolbox for a set of
    whitelisted shapes.

    `transition_data` is the block-state-transition CircuitData (the final
    GL circuit verifies it under constant verifier data). Every circuit is
    built for `device` (CUDA unless ``"cpu"``), where its preprocessing
    and proofs run. `with_groth16=True` also builds the Groth16 wrap
    statement over the final GL's fingerprint and runs its trusted setup
    (an explicit `groth16_seed` needs `groth16_dev=True`)."""

    def __init__(self, config: CircuitConfig,
                 spend_cfg: btc.BlockSpendCoreConfig, script_body: bytes,
                 gadget_ids: list, transition_data,
                 with_groth16: bool = False,
                 groth16_seed: bytes | None = None,
                 groth16_dev: bool = False, device=None):
        self.config = config
        self.device = device
        self.spend_cfg = spend_cfg
        self.script_body = script_body
        self.shapes: dict = {}           # gid.to_felt() -> BuiltSigHashShape

        # -- pass 1: probe builds, harvest gate union + max degree ----------
        gate_objs: dict = {}
        log_d = 0
        circuits = {}
        for gid in gadget_ids:
            shape = SigHashShape(gid=gid, cfg=spend_cfg)
            circ = SigHashCircuit.build(config, shape, script_body,
                                        device=device)
            circuits[gid.to_felt()] = circ
            probe = ProofMinifier.build(circ.data, config, device=device)
            for g in probe.data.common.gates:
                gate_objs.setdefault(g.key, g)
            log_d = max(log_d, probe.data.common.log_n)

        # -- pass 2: declared rebuild onto the shared shape -----------------
        gates = [gate_objs[k] for k in sorted(gate_objs)]
        shared_key = None
        for gid in gadget_ids:
            circ = circuits[gid.to_felt()]
            mini = ProofMinifier.build(circ.data, config,
                                       declared_gates=list(gates),
                                       min_log_n=log_d, device=device)
            key = common_shape_key(mini.data.common)
            if shared_key is None:
                shared_key = key
                self.minified_common = mini.data.common
            assert key == shared_key, \
                f"sighash shape {gid} diverged from the shared minified shape"
            self.shapes[gid.to_felt()] = BuiltSigHashShape(
                gid=gid, circuit=circ, minifier=mini)

        # -- whitelist + wrapper + final GL ---------------------------------
        fps = [s.fingerprint for s in self.shapes.values()]
        self._build_tail(fps, transition_data, with_groth16, groth16_seed,
                         groth16_dev)

    def _build_tail(self, fps: list, transition_data, with_groth16: bool,
                    groth16_seed: bytes | None, groth16_dev: bool):
        """The whitelist over `fps`, the wrapper over the shared minified
        shape, the final GL over (transition, wrapper) and, with
        `with_groth16`, the Groth16 wrap over the final GL's
        fingerprint."""
        self.whitelist = SigHashMerkleTree.build(fps)
        self.wrapper = SigHashWrapperCircuit.build(
            self.config, self.minified_common, self.whitelist,
            device=self.device)
        self.final_gl = SigHashFinalGLCircuit.build(
            self.config, transition_data, self.wrapper.data,
            device=self.device)
        self.final_fingerprint = tuple(
            fingerprint_verifier_data(self.final_gl.data.verifier))
        self.groth16 = None
        if with_groth16:
            from .groth16_wrap import Groth16WrapCircuit
            self.groth16 = Groth16WrapCircuit.build(
                self.final_fingerprint, setup_seed=groth16_seed,
                dev_deterministic=groth16_dev)

    @classmethod
    def from_corpus(cls, config: CircuitConfig, corpus, transition_data,
                    with_groth16: bool = False,
                    groth16_seed: bytes | None = None,
                    groth16_dev: bool = False,
                    device=None) -> "SigHashToolbox":
        """Build the toolbox from a precomputed fingerprint corpus
        (rollup/sighash_corpus.py): the whitelist tree covers EVERY pinned
        fingerprint (sorted by gid felt) without building their circuits;
        shape circuits build lazily on first prove, each asserting its
        fingerprint matches the pinned entry. This is the reference's
        worker posture — 1,875 pinned fingerprints loaded from config,
        circuits cached per config on demand (sighash_wrapper_config.rs:24,
        sighash_wrapper.rs:58,129-160)."""
        from . import sighash_corpus as sc
        self = cls.__new__(cls)
        self.config = config
        self.device = device
        assert sc._config_key(config) == corpus.config_key, \
            "corpus was generated for a different CircuitConfig"
        self.spend_cfg = corpus.spend_cfg
        self.script_body = corpus.script_body
        self.corpus = corpus
        self.shapes = {}
        # shared minified shape: derive from the cheapest layout once
        _, mini0 = sc.build_entry(config, corpus,
                                  btc.SigHashGadgetId(0, 0, 0, 0, 0),
                                  device=device)
        self.minified_common = mini0.data.common
        self._shared_shape_key = common_shape_key(self.minified_common)
        self._build_tail([corpus.fps[k] for k in sorted(corpus.fps)],
                         transition_data, with_groth16, groth16_seed,
                         groth16_dev)
        return self

    # -- proving -------------------------------------------------------------
    def shape_for(self, gid_felt: int) -> BuiltSigHashShape:
        s = self.shapes.get(int(gid_felt))
        if s is None and getattr(self, "corpus", None) is not None \
                and int(gid_felt) in self.corpus.fps:
            from . import sighash_corpus as sc
            gid = _gid_from_felt(int(gid_felt))
            circ, mini = sc.build_entry(self.config, self.corpus, gid,
                                        expect_shape_key=
                                        self._shared_shape_key,
                                        device=self.device)
            got = tuple(int(x) for x in mini.fingerprint)
            assert got == self.corpus.fps[int(gid_felt)], \
                f"rebuilt fingerprint for {gid} diverges from the corpus pin"
            s = BuiltSigHashShape(gid=gid, circuit=circ, minifier=mini)
            self.shapes[int(gid_felt)] = s
        assert s is not None, f"sighash shape {gid_felt} not in toolbox"
        return s

    def prove_introspection(self, hint: btc.BlockSpendIntrospectionHint
                            ) -> Proof:
        """SIGHASH_INTROSPECTION job: prove the shape circuit, minify to
        the shared shape."""
        s = self.shape_for(hint.gadget_id().to_felt())
        inner = s.circuit.prove(hint)
        return s.minifier.prove(inner)

    def prove_wrapper(self, minified_proof: Proof, gid_felt: int) -> Proof:
        """SIGHASH_WRAPPER job: whitelist-inclusion + recursive verify."""
        s = self.shape_for(gid_felt)
        return self.wrapper.prove(minified_proof, s.minifier.data.verifier,
                                  s.fingerprint)

    def prove_final(self, transition_proof: Proof, wrapper_proof: Proof,
                    components: dict) -> Proof:
        """SIGHASH_FINAL_GL job."""
        return self.final_gl.prove(transition_proof, wrapper_proof,
                                   components)

    def wrap_groth16(self, final_proof: Proof) -> dict:
        """WRAP_FINAL_SIGHASH_PROOF_BLS12381 job -> CityGroth16ProofData."""
        from .groth16_wrap import wrap_final_proof
        assert self.groth16 is not None, "toolbox built without groth16"
        return wrap_final_proof(self.groth16, self.final_gl.data,
                                final_proof)
