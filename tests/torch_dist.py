"""Spawned gloo ranks for the port's distributed tests, and the functions
they run.

This module imports neither JAX nor the reference package: a spawned rank
imports it to find its function. ``start_ranks`` spawns one process per
rank, each joining a CPU process group (gloo, a ``FileStore`` in the given
directory, so that concurrent test workers never share a port, and a 60 s
collective timeout); ``RankRun.join`` waits under a time limit, kills every
rank on failure or timeout, and returns each rank's result.
"""

from __future__ import annotations

import datetime
import multiprocessing
import pickle
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

P = 0xFFFF_FFFF_0000_0001
GROUP_TIMEOUT_S = 60


def _rank_main(fn, rank: int, world: int, workdir: str, args) -> None:
    torch.set_num_threads(1)
    out = Path(workdir)
    try:
        dist.init_process_group(
            "gloo", store=dist.FileStore(str(out / "store"), world),
            rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
        try:
            result = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        (out / f"rank{rank}.pkl").write_bytes(pickle.dumps(result))
    except BaseException:
        (out / f"rank{rank}.err").write_text(traceback.format_exc())
        raise


class RankRun:
    def __init__(self, procs, workdir: Path, timeout: float):
        self.procs = procs
        self.workdir = workdir
        self.deadline = time.monotonic() + timeout

    def join(self) -> list:
        """Every rank's result, in rank order; raises (having killed every
        rank) if one failed or the time limit passed."""
        for p in self.procs:
            p.join(max(0.0, self.deadline - time.monotonic()))
        failed = [p for p in self.procs if p.is_alive() or p.exitcode != 0]
        if failed:
            for p in self.procs:
                if p.is_alive():
                    p.kill()
                p.join()
            errs = [e.read_text() for e in sorted(self.workdir.glob("*.err"))]
            raise RuntimeError(f"{len(failed)} of {len(self.procs)} ranks "
                               f"failed or timed out:\n" + "\n".join(errs))
        return [pickle.loads((self.workdir / f"rank{r}.pkl").read_bytes())
                for r in range(len(self.procs))]


def start_ranks(fn, world: int, workdir, *args,
                timeout: float = 120.0) -> RankRun:
    """Spawn ``world`` ranks running fn(rank, world, *args)."""
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, str(workdir), args), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    return RankRun(procs, workdir, timeout)


def outcome(fn, *args):
    """("ok", fn(*args)) or ("raises", exception type name, message)."""
    try:
        return ("ok", fn(*args))
    except Exception as e:          # noqa: BLE001 - the outcome is the result
        return ("raises", type(e).__name__, str(e))


# ---------------------------------------------------------------------------
# Inputs (seeded numpy, shared by the ranks and the tests' oracles)
# ---------------------------------------------------------------------------

def rand_u64(seed: int, shape) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, P, size=shape,
                                                dtype=np.uint64)


# name -> (seed, shape, log_n, rate_bits, leaf_width, cap_height)
LDE_COMMITS = {
    "lde_commit": (3, 1 << 7, 7, 3, 8, 4),
    "dryrun_multichip": (1, 1 << 10, 10, 3, 32, 4),
}
NTT = (0, 1 << 8, 8)
COSET_LDE = (1, 1 << 6, 6, 3)
MERKLE = (2, (64, 8), 4)
BATCHED = (5, (8, 1 << 6), 6, 3)


def parallel_cases(rank: int, world: int) -> dict:
    """Every parallel/ case on a CPU mesh: the gathered outputs as uint64
    arrays, and the outcome of each call that must raise."""
    from city_rollup_tpu_torch import convert
    from city_rollup_tpu_torch.parallel import (dist_merkle, dist_ntt,
                                                dist_pipeline)
    from city_rollup_tpu_torch.parallel import mesh as mesh_mod

    res = {"bad n_devices": outcome(mesh_mod.make_mesh, world + 1, "x",
                                    "cpu"),
           "cuda mesh": outcome(mesh_mod.make_mesh)}
    mesh = mesh_mod.make_mesh(world, device="cpu")
    res["rank"] = mesh_mod.rank(mesh)

    def gathered(t):
        return convert.to_u64(mesh_mod.gather(mesh, t))

    seed, n, log_n = NTT
    res["dist_ntt"] = gathered(dist_ntt.dist_ntt(mesh, rand_u64(seed, n),
                                                 log_n))
    seed, n, log_n, rate = COSET_LDE
    res["dist_coset_lde"] = gathered(dist_ntt.dist_coset_lde(
        mesh, rand_u64(seed, n), log_n, rate))
    seed, shape, cap_h = MERKLE
    res["dist_merkle_cap"] = convert.to_u64(dist_merkle.dist_merkle_cap(
        mesh, rand_u64(seed, shape), cap_h))
    for name, (seed, n, log_n, rate, width, cap_h) in LDE_COMMITS.items():
        cap, lde = dist_pipeline.dist_lde_commit(
            mesh, rand_u64(seed, n), log_n, rate, width, cap_h)
        res[name] = (convert.to_u64(cap), gathered(lde))
    seed, shape, log_n, rate = BATCHED
    res["dist_batched_coset_lde"] = gathered(
        dist_ntt.dist_batched_coset_lde(mesh, rand_u64(seed, shape), log_n,
                                        rate))
    if world > 1:
        # a 2^lg transform (lg = log2 D) splits into R x C with C < D, and
        # a cap of 2^(lg - 1) digests is smaller than the mesh
        lg = world.bit_length() - 1
        res["split"] = outcome(dist_ntt.dist_ntt, mesh, rand_u64(6, 1 << lg),
                               lg)
        res["split lde_commit"] = outcome(dist_pipeline.dist_lde_commit, mesh,
                                          rand_u64(6, 1 << lg), lg, 0, 1, lg)
        res["small cap"] = outcome(dist_merkle.dist_merkle_cap, mesh,
                                   rand_u64(7, (16, 8)), lg - 1)
        res["small cap lde_commit"] = outcome(
            dist_pipeline.dist_lde_commit, mesh, rand_u64(8, 1 << 6), 6, 2,
            4, lg - 1)
        res["batch"] = outcome(dist_ntt.dist_batched_coset_lde, mesh,
                               rand_u64(9, (world + 1, 16)), 4, 1)
    res["imports"] = imported_reference()
    return res


# ---------------------------------------------------------------------------
# prove_batch(mesh=...)
# ---------------------------------------------------------------------------

MESH_PROVE_FRI = dict(rate_bits=3, cap_height=1, proof_of_work_bits=4,
                      num_query_rounds=4, final_poly_bits=3)


def mesh_prove_circuit(builder_cls, config_cls, fri_cls, batch: int):
    """tests/test_mesh_prove.py's circuit (y = x * (x + 5), y public) under
    its FAST configuration, and `batch` witnesses x = 1 .. batch."""
    b = builder_cls(config_cls.poseidon_config(
        num_challenges=1, fri=fri_cls(**MESH_PROVE_FRI)))
    x = b.add_virtual_target()
    b.register_public_input(b.mul(x, b.add_const(x, 5)))
    pws = []
    for v in range(batch):
        pw = b.partial_witness()
        pw.set(x, v + 1)
        pws.append(pw)
    return b, pws


def mesh_prove_cases(rank: int, world: int, batch: int) -> dict:
    """prove_batch(mesh=) of `batch` witnesses over the CPU mesh (plain
    proofs, every rank's), and a batch of world + 1 that must raise."""
    from city_rollup_tpu_torch import convert
    from city_rollup_tpu_torch.core import fri
    from city_rollup_tpu_torch.parallel import mesh as mesh_mod
    from city_rollup_tpu_torch.snark import (CircuitBuilder, CircuitConfig,
                                             prover)

    mesh = mesh_mod.make_mesh(world, device="cpu")
    b, pws = mesh_prove_circuit(CircuitBuilder, CircuitConfig,
                                fri.FriConfig, batch)
    data = b.build(device="cpu")
    steps = []
    proofs = prover.prove_batch(data, pws, on_step=steps.append, mesh=mesh)
    res = {"proofs": [convert.proof_to_plain(p) for p in proofs],
           "steps": steps}
    if world > 1:
        res["odd batch"] = outcome(prover.prove_batch, data,
                                   pws[:world + 1], None, mesh)
    res["imports"] = imported_reference()
    return res


def imported_reference() -> list[str]:
    """The modules of JAX or of the reference package this rank imported."""
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "city_rollup_tpu"))
