"""A cell run end to end on the CPU at the test configuration's size
(trees of height 4, one challenge, FRI at rate 1/8 with one query round:
the port's test-size RollupParams, a family of 2^13 rows), the harness's
look for a chip skipped: the sound run comes out correct, and the control
and every planted fault come out not correct.

The cells are throwaway files added to a temporary copy of the benchmark:
a configuration, two traffic mixes and their workloads. Both families (the
program's and the reference's) are built once for the module. The run
proves two worker calls (the warm-up and one window call), so these tests
take minutes of CPU.
"""

import json
import time

import pytest
import torch

from portbench import control, harness

from conftest import copy_benchmark

TEST_CONFIG = {
    "name": "city_test.family_b", "family": "B",
    "source": "test size",
    "circuit_config": {
        "num_wires": 144, "num_routed_wires": 32, "num_constants": 2,
        "num_challenges": 1, "max_constraint_degree": 8, "zk": False,
        "fri": {"rate_bits": 3, "cap_height": 1, "proof_of_work_bits": 2,
                "num_query_rounds": 1, "final_poly_bits": 3}},
    "rollup_params": {"user_tree_height": 4, "deposit_tree_height": 4,
                      "withdrawal_tree_height": 4},
    "reduced": ["user_tree_height", "deposit_tree_height",
                "withdrawal_tree_height", "circuit_config"]}
MIX = {"work": "rollup_leaves", "genesis_users": 4, "genesis_balance": 10 ** 9,
       "value_range": [1, 1000], "prelude": {"add_withdrawal": 4},
       "blocks": 2, "per_block": {"process_withdrawal": 2, "add_deposit": 2},
       "check": {"verify_sample": 1}}
CELLS = {"test.single": {"loop": "process_next_job"},
         "test.batched": {"loop": "process_ready_batch", "max_batch": 2}}
SEED = 2 ** 31 + 12345
SECONDS = 1e-3          # one window call


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    base = copy_benchmark(tmp_path_factory.mktemp("cpu_cell") / "checkout")
    (base / "configs" / "city_test.family_b.json").write_text(
        json.dumps(TEST_CONFIG))
    manifest = json.loads((base.parent / "BENCHMARK.json").read_text())
    for name, loop in CELLS.items():
        (base / "traffic" / f"{name}.json").write_text(
            json.dumps(dict(MIX, worker=loop)))
        manifest["workloads"].append(
            {"name": name, "config": "city_test.family_b", "traffic": name,
             "chips": 1, "why": "test"})
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        m.pop("workloads", None)
    (base.parent / "BENCHMARK.json").write_text(json.dumps(manifest))
    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    yield base, {"keep": True}
    torch.set_num_threads(threads)


def run(bench, cell, trace=False, mutate=None):
    base, cache = bench
    return harness.run_cell(cell, SEED, SECONDS, trace, time.perf_counter(),
                            base.parent, device="cpu", base=base,
                            mutate=mutate, cache=cache)


def test_sound_run_is_correct_and_traced(bench):
    res = run(bench, "test.single", trace=True)
    assert res["correct"], res["checks"]
    assert res["attempted"] == 1 and res["failed"] == 0
    assert res["window"]["warm_jobs"] == 1 and res["window"]["proven"] == 1
    assert all(c["value"] == 0 for c in res["checks"].values())
    assert list(res)[-1] == "checks"
    m = res["metrics"]
    # host spans are read on the CPU; device metrics have nothing to read
    assert m["witness.s_per_proof"]["value"] > 0
    assert m["passes.quotient_s_per_proof"]["value"] > 0
    for name in ("kernels.ntt_roofline", "device.idle_share",
                 "worker.batch_occupancy", "leaf_proofs_per_s"):
        assert name not in m


def test_batched_run_reports_occupancy(bench):
    res = run(bench, "test.batched")
    assert res["correct"], res["checks"]
    assert res["attempted"] == 2
    assert res["metrics"]["leaf_proofs_per_s"]["value"] > 0
    assert res["metrics"]["setup_s"]["value"] > 0


# each run pops the warm-up call's jobs and one window call's; the sample
# verifies one proof of the window
@pytest.mark.parametrize("cell,mutation,reading", [
    ("test.single", "fewer_queries", {"proofs_rejected": 1}),
    ("test.single", "altered_proof", {"proofs_rejected": 1}),
    ("test.single", "altered_statement", {"pi_mismatches": 2,
                                          "proofs_rejected": 1}),
    ("test.single", "unwritten_proof", {"jobs_unproven": 2,
                                        "proofs_unverified": 1}),
    ("test.batched", "half_batch", {"jobs_unproven": 2}),
])
def test_control_and_faults_are_not_correct(bench, cell, mutation, reading):
    res = run(bench, cell, mutate=control.MUTATIONS[mutation])
    assert not res["correct"]
    assert {k: c["value"] for k, c in res["checks"].items() if c["value"]} \
        == reading
    assert res["failed"] > 0
