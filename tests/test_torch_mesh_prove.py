"""prove_batch(mesh=...) on CPU meshes of 1 and 2 gloo ranks, with
tests/test_mesh_prove.py's circuit (y = x * (x + 5) under its FAST
configuration) and B = 4: every rank returns all four proofs, equal field
for field to the port's unsharded prove_batch, and they pass the reference's
host verifier.

The reference's own prove_batch(mesh=...) cannot be the oracle: it raises
NameError for every batch (it does not pass ``mesh`` on; ROADMAP.md,
reference caveats), so tests/test_mesh_prove.py cannot pass as written."""

import pytest
import torch

import torch_dist
from city_rollup_tpu.core import fri as jfri
from city_rollup_tpu.snark import CircuitBuilder as JBuilder
from city_rollup_tpu.snark import CircuitConfig as JConfig
from city_rollup_tpu.snark import circuit as jcircuit
from city_rollup_tpu.snark import verifier as jverifier
from city_rollup_tpu_torch import convert
from city_rollup_tpu_torch.core import fri
from city_rollup_tpu_torch.snark import CircuitBuilder, CircuitConfig
from city_rollup_tpu_torch.snark import prover, verifier
from test_torch_snark import ref_proof_from_plain

WORLDS = (1, 2)
BATCH = 4


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the port's circuit data, its unsharded batch's plain proofs,
    {world: every rank's results, or the error that ended the run})."""
    started = {w: torch_dist.start_ranks(
        torch_dist.mesh_prove_cases, w, tmp_path_factory.mktemp(f"world{w}"),
        BATCH) for w in WORLDS}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        b, pws = torch_dist.mesh_prove_circuit(CircuitBuilder, CircuitConfig,
                                               fri.FriConfig, BATCH)
        data = b.build(device="cpu")
        plain = [convert.proof_to_plain(p)
                 for p in prover.prove_batch(data, pws)]
    finally:
        torch.set_num_threads(threads)
    results = {}
    for w, run in started.items():
        try:
            results[w] = run.join()
        except RuntimeError as e:
            results[w] = e
    return data, plain, results


def _ranks(runs, world):
    res = runs[2][world]
    if isinstance(res, Exception):
        raise res
    return res


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_proofs_equal_the_unsharded_batch(runs, world):
    _, plain, _ = runs
    assert [p[0] for p in plain] == [[x * (x + 5)] for x in range(1, 5)]
    for res in _ranks(runs, world):
        assert len(res["proofs"]) == BATCH
        assert res["proofs"] == plain


@pytest.mark.parametrize("world", WORLDS)
def test_each_rank_proves_its_slice(runs, world):
    """on_step reaches the single-device prove of each rank's B / D."""
    for res in _ranks(runs, world):
        assert res["steps"][0] == "witness"
        assert res["steps"][-1] == "initial openings"
        assert len(res["steps"]) == 10


@pytest.mark.parametrize("world", WORLDS)
def test_ranks_import_no_reference(runs, world):
    for res in _ranks(runs, world):
        assert res["imports"] == []


def test_a_batch_that_does_not_divide_the_mesh_raises(runs):
    for res in _ranks(runs, 2):
        outcome = res["odd batch"]
        assert outcome[:2] == ("raises", "ValueError"), outcome


def test_mesh_proofs_pass_both_verifiers(runs):
    """Proof 3 of the 2-rank mesh (the last rank's) through the reference's
    host verifier, given the reference's host build of the same circuit
    and the port's verifier data; and every proof through the port's."""
    data, _, _ = runs
    proofs = _ranks(runs, 2)[0]["proofs"]
    jb, _ = torch_dist.mesh_prove_circuit(JBuilder, JConfig, jfri.FriConfig,
                                          0)
    jd = jb.build()
    vd = jcircuit.VerifierData(
        constants_sigmas_cap=data.verifier.constants_sigmas_cap,
        circuit_digest=data.verifier.circuit_digest)
    assert jverifier.verify(ref_proof_from_plain(proofs[3]), jd.common, vd)
    for plain in proofs:
        assert verifier.verify(convert.proof_from_plain(plain), data.common,
                               data.verifier)
    wrong = convert.proof_from_plain(proofs[3])
    wrong.public_inputs[0] = (wrong.public_inputs[0] + 1) % torch_dist.P
    assert not jverifier.verify(
        ref_proof_from_plain(convert.proof_to_plain(wrong)), jd.common, vd)
