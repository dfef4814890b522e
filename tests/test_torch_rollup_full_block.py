"""`python -m city_rollup_tpu_torch.cli full-block --fast --device cpu`,
end to end on the port on the CPU (slow: every proof of the demo block at
FAST_TEST_PARAMS, 2^14 rows, on the plain PyTorch versions of the
kernels).

The CLI's own command proves and finalizes the demo block and dumps its
proof store (--dump); the final proof there (the block state transition)
carries the reference's planned city roots and passes the reference's
verifier."""

import json

import numpy as np
import pytest
import torch

from city_rollup_tpu.rollup import circuits as jcircuits
from city_rollup_tpu.rollup import orchestrator as jom
from city_rollup_tpu.rollup.city_store import CityStore as JCityStore
from city_rollup_tpu.rollup.proof_store import MemoryProofStore as JStore
from city_rollup_tpu.rollup.queues import QueueHub as JHub
from city_rollup_tpu.snark import circuit as jcircuit
from city_rollup_tpu.snark import verifier as jverifier
from city_rollup_tpu_torch import cli, convert
from city_rollup_tpu_torch.rollup.circuits import (FAST_TEST_PARAMS,
                                                   CircuitToolbox,
                                                   decode_proof)
from city_rollup_tpu_torch.rollup.job_id import JobID
from city_rollup_tpu_torch.rollup.proof_store import MemoryProofStore
from test_torch_rollup_plan import _as_ref
from test_torch_snark import ref_proof_from_plain


def _city(mod_city, p):
    city = mod_city(user_tree_height=p.user_tree_height,
                    deposit_tree_height=p.deposit_tree_height,
                    withdrawal_tree_height=p.withdrawal_tree_height)
    cli.demo_genesis(city, p)
    return city


@pytest.mark.slow
def test_cli_full_block_fast_on_the_cpu(tmp_path, capsys):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        dump = tmp_path / "block.json"
        assert cli.main(["full-block", "--fast", "--device", "cpu",
                         "--dump", str(dump)]) == 0
        out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert out["ok"] and out["jobs"] == 15

        # the reference's plan of the same block: its roots, its final job
        jp = jcircuits.FAST_TEST_PARAMS
        jplanned = jom.Orchestrator(_city(JCityStore, jp), JStore(), JHub(),
                                    params=jp).plan_block(
            1, _as_ref(cli.demo_requests()))
        store = MemoryProofStore.restore(json.loads(dump.read_text())["store"])
        proof = decode_proof(store.get_proof(JobID.from_bytes(
            jplanned.final_job.output_proof_id().to_bytes())))
        assert proof.public_inputs[0:4] == list(jplanned.start_city_root)
        assert proof.public_inputs[4:8] == list(jplanned.end_city_root)

        # the reference's verifier, against the transition circuit's
        # shape (the reference's gates of the same keys) and the port's
        # verifier data of it (the toolbox is deterministic)
        data = CircuitToolbox(FAST_TEST_PARAMS,
                              device="cpu").block["transition"][0]
        vd = jcircuit.VerifierData(
            constants_sigmas_cap=np.asarray(
                data.verifier.constants_sigmas_cap, dtype=np.uint64),
            circuit_digest=[int(v) for v in data.verifier.circuit_digest])
        jcommon = jcircuit.CommonData(
            config=jp.config, log_n=data.common.log_n,
            gates=[_ref_gate(g) for g in data.common.gates],
            selector_groups=data.common.selector_groups,
            num_public_inputs=data.common.num_public_inputs)
        jproof = ref_proof_from_plain(convert.proof_to_plain(proof))
        assert jverifier.verify(jproof, jcommon, vd)
    finally:
        torch.set_num_threads(threads)


def _ref_gate(g):
    """The reference's gate of the same key."""
    from city_rollup_tpu.snark import gates as jg
    from city_rollup_tpu.snark.gate_poseidon import PoseidonGate
    name, _, arg = g.key.partition("<")
    arg = int(arg[:-1]) if arg else None
    return {"arithmetic": lambda: jg.ArithmeticGate(arg),
            "base_sum": lambda: jg.BaseSumGate(arg),
            "constant": lambda: jg.ConstantGate(arg),
            "public_input": jg.PublicInputGate,
            "reducing": lambda: jg.ReducingGate(arg),
            "reducing_ext": lambda: jg.ReducingExtGate(arg),
            "poseidon": PoseidonGate}[name]()
