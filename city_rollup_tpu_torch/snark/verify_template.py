"""Serializable verifier templates: a JSON-able description of a circuit's
verifier-facing layout (shape, gate set, public-input count, verifier key
digests) plus proof-shape metadata.

Reference role: city_common_circuit/src/verify_template/ (SURVEY.md §2.2
"Verify template" — circuit_template.rs / ser_data.rs): lets external
tooling (block explorers, the patched-node verifier, cross-language
verifiers) reconstruct exactly what a proof of a given circuit must look
like without importing the circuit-building code.

Counterpart of the reference's ``snark/verify_template.py``: the same code over the port's
``core/`` and ``snark/`` (host Python).
"""

from __future__ import annotations

import json

from .circuit import CircuitData
from .recursion import fingerprint_verifier_data


def circuit_template(data: CircuitData) -> dict:
    """The verifier-layout description of a built circuit."""
    common = data.common
    vd = data.verifier
    cfg = common.config
    return {
        "version": 1,
        "log_n": common.log_n,
        "num_public_inputs": common.num_public_inputs,
        "config": {
            "num_wires": cfg.num_wires,
            "num_routed_wires": cfg.num_routed_wires,
            "num_constants": cfg.num_constants,
            "num_challenges": cfg.num_challenges,
            "max_constraint_degree": cfg.max_constraint_degree,
            "zk": cfg.zk,
            "fri": {
                "rate_bits": cfg.fri.rate_bits,
                "cap_height": cfg.fri.cap_height,
                "proof_of_work_bits": cfg.fri.proof_of_work_bits,
                "num_query_rounds": cfg.fri.num_query_rounds,
                "final_poly_bits": cfg.fri.final_poly_bits,
            },
        },
        "gates": [g.key for g in common.gates],
        "selector_groups": [list(g) for g in common.selector_groups],
        "verifier": {
            "circuit_digest": [int(x) for x in vd.circuit_digest],
            "constants_sigmas_cap": [[int(v) for v in row]
                                     for row in vd.constants_sigmas_cap],
            "fingerprint": [int(x) for x in
                            fingerprint_verifier_data(vd)],
        },
    }


def template_to_json(data: CircuitData) -> str:
    return json.dumps(circuit_template(data), indent=1)


def template_shape_key(template: dict) -> tuple:
    """Stable shape identity: two circuits with equal keys accept
    interchangeable proofs (the CommonData-sharing invariant the shape
    families maintain)."""
    cfg = template["config"]
    return (template["log_n"], template["num_public_inputs"],
            tuple(template["gates"]),
            tuple(tuple(g) for g in template["selector_groups"]),
            cfg["num_wires"], cfg["num_routed_wires"],
            cfg["num_challenges"], tuple(sorted(cfg["fri"].items())))


def validate_proof_shape(template: dict, proof) -> bool:
    """Cheap structural check that `proof` matches the template (counts
    only — full verification is snark.verifier.verify)."""
    cfg = template["config"]
    fri_cfg = cfg["fri"]
    if len(proof.public_inputs) != template["num_public_inputs"]:
        return False
    if len(proof.fri_proof.query_rounds) != fri_cfg["num_query_rounds"]:
        return False
    if len(proof.openings.wires) != cfg["num_wires"]:
        return False
    return True
