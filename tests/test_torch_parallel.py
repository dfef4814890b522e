"""The port's parallel/ on CPU meshes of 1, 2 and 4 gloo ranks against the
reference's single-device functions, bit for bit, at tests/test_parallel.py's
shapes (and __graft_entry__.dryrun_multichip's fused LDE + commit).

Each world size's ranks are spawned once (tests/torch_dist.py, which imports
no JAX) and run every case; the reference computes its oracles here while
they run. A D = 1 mesh cannot catch a wrong all-to-all layout: D = 2 and 4
can."""

import functools
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_dist
from city_rollup_tpu.core import gl64, merkle, ntt
from city_rollup_tpu.parallel import dist_ntt as jdist_ntt
from city_rollup_tpu_torch.parallel import dist_ntt
from city_rollup_tpu_torch.parallel import mesh as mesh_mod

WORLDS = (1, 2, 4)
SPLIT_WORLDS = (2, 4)


def _u64(pair) -> np.ndarray:
    return gl64.to_u64(np.asarray(pair[0]), np.asarray(pair[1]))


def _ref_commit(coeffs, log_n, rate, width, cap_h):
    lde = ntt.coset_lde(gl64.from_u64(coeffs), log_n, rate)
    tree = merkle.MerkleTree((lde[0].reshape(-1, width),
                              lde[1].reshape(-1, width)), cap_h)
    return tree.cap_u64(), _u64(lde)


def _oracles() -> dict:
    """The reference's single-device outputs on the ranks' inputs. Each is
    a few XLA compiles; they run in threads, side by side."""
    rand = torch_dist.rand_u64
    jobs = {}
    seed, n, log_n = torch_dist.NTT
    jobs["dist_ntt"] = lambda: _u64(ntt.ntt(gl64.from_u64(rand(seed, n)),
                                            log_n))
    seed1, n1, log_n1, rate1 = torch_dist.COSET_LDE
    jobs["dist_coset_lde"] = lambda: _u64(ntt.coset_lde(
        gl64.from_u64(rand(seed1, n1)), log_n1, rate1))
    seed2, shape2, cap_h = torch_dist.MERKLE
    jobs["dist_merkle_cap"] = lambda: merkle.MerkleTree(
        gl64.from_u64(rand(seed2, shape2)), cap_height=cap_h).cap_u64()
    for name, (seed3, n3, *args) in torch_dist.LDE_COMMITS.items():
        jobs[name] = functools.partial(_ref_commit, rand(seed3, n3), *args)
    seed4, shape4, log_n4, rate4 = torch_dist.BATCHED
    jobs["dist_batched_coset_lde"] = lambda: _u64(ntt.coset_lde(
        gl64.from_u64(rand(seed4, shape4)), log_n4, rate4))

    def run(fn):
        with np.errstate(over="ignore"):
            return fn()

    with ThreadPoolExecutor(len(jobs)) as pool:
        futures = {k: pool.submit(run, fn) for k, fn in jobs.items()}
        return {k: f.result() for k, f in futures.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(oracles, {world: every rank's results, or the error that ended
    the run})."""
    started = {w: torch_dist.start_ranks(
        torch_dist.parallel_cases, w, tmp_path_factory.mktemp(f"world{w}"))
        for w in WORLDS}
    oracles = _oracles()
    results = {}
    for w, run in started.items():
        try:
            results[w] = run.join()
        except RuntimeError as e:
            results[w] = e
    return oracles, results


def _ranks(runs, world):
    res = runs[1][world]
    if isinstance(res, Exception):
        raise res
    assert [r["rank"] for r in res] == list(range(world))
    return res


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", ["dist_ntt", "dist_coset_lde",
                                  "dist_merkle_cap", "dist_batched_coset_lde"])
def test_matches_single_device(runs, world, case):
    want = runs[0][case]
    for res in _ranks(runs, world):
        np.testing.assert_array_equal(res[case], want)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", list(torch_dist.LDE_COMMITS))
def test_lde_commit_matches_single_device(runs, world, case):
    """The fused LDE + commit: the cap replicated on every rank, the
    gathered LDE the single-device coset LDE."""
    cap, lde = runs[0][case]
    for res in _ranks(runs, world):
        np.testing.assert_array_equal(res[case][0], cap)
        np.testing.assert_array_equal(res[case][1], lde)


@pytest.mark.parametrize("world", WORLDS)
def test_ranks_import_no_reference(runs, world):
    for res in _ranks(runs, world):
        assert res["imports"] == []


def _raised(res, case, exc="ValueError"):
    outcome = res[case]
    assert outcome[0] == "raises", f"{case}: returned"
    assert outcome[1] == exc, outcome


@pytest.mark.parametrize("world", SPLIT_WORLDS)
def test_a_mesh_that_does_not_divide_r_or_c_raises(runs, world):
    for res in _ranks(runs, world):
        _raised(res, "split")
        _raised(res, "split lde_commit")


@pytest.mark.parametrize("world", SPLIT_WORLDS)
def test_a_cap_smaller_than_the_mesh_raises(runs, world):
    for res in _ranks(runs, world):
        _raised(res, "small cap")
        _raised(res, "small cap lde_commit")


@pytest.mark.parametrize("world", SPLIT_WORLDS)
def test_a_poly_batch_that_does_not_divide_raises(runs, world):
    for res in _ranks(runs, world):
        _raised(res, "batch")


@pytest.mark.parametrize("world", WORLDS)
def test_n_devices_unlike_the_world_size_raises(runs, world):
    for res in _ranks(runs, world):
        _raised(res, "bad n_devices")


@pytest.mark.parametrize("world", WORLDS)
def test_a_cuda_mesh_without_a_gpu_raises(runs, world):
    """The default mesh is CUDA: with no GPU it raises, with no fallback."""
    for res in _ranks(runs, world):
        _raised(res, "cuda mesh",
                "ValueError" if torch.cuda.is_available() else "RuntimeError")


def test_make_mesh_needs_a_process_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        mesh_mod.make_mesh(device="cpu")


@pytest.mark.parametrize("log_n", [1, 8, 11])
def test_four_step_twiddles_match_the_references(log_n):
    ref = jdist_ntt._four_step_twiddles(log_n)
    np.testing.assert_array_equal(dist_ntt._four_step_twiddles(log_n), ref)
    c = ref.shape[0]
    for d in (2, 4):
        if c % d == 0:
            for r in range(d):
                rows = slice(r * c // d, (r + 1) * c // d)
                np.testing.assert_array_equal(
                    dist_ntt._four_step_twiddles(log_n, rows.start,
                                                 rows.stop), ref[rows])
