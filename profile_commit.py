#!/usr/bin/env python3
"""Where the device time of the two commits, FRI and the prover goes, on one
GPU.

    python3 profile_commit.py [--out DIR]

Runs lde_commit at 2^20 x 64 and lde_commit_streamed at 2^22 x 64
(rate_bits 3, cap_height 4), fri_prove (FriConfig() defaults) of the ext
codeword of a random degree < 2^20 pair (log_m 23), and the snark
prove_batch of 8 witnesses of chip_smoke's full-width circuit (log_n 12,
CircuitConfig.poseidon_config(), FriConfig() defaults), and the prove of
the wrapper that verifies one such proof in-circuit (log_n 15,
minifier.ProofMinifier), of the PyTorch/CUDA port once each to warm up,
then once each under torch.profiler (and each prove once more with its
steps timed). --only TAG... runs only those (lde_commit_20,
lde_commit_streamed_22, fri_prove_23, prove_batch_8, wrap_prove_15). For
each run it prints the
wall time, the summed device time of its kernels (one stream, so
the kernels do not overlap), the device's idle share, and the kernels by
device time, then every device kernel that is not one of the port's own
(csrc/) by name: the torch ops left around the kernels. It writes the
Chrome trace to DIR (default profile_out/). The last line is one JSON
object with the same numbers. It fails without CUDA.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

P = 0xFFFF_FFFF_0000_0001


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def _is_kernel(evt) -> bool:
    return getattr(evt, "device_type", None) == torch.autograd.DeviceType.CUDA


# The port's own kernels (csrc/); every other device kernel is a torch op.
PORT_KERNELS = ("ntt_block_kernel", "ntt_tail_kernel", "sponge_kernel",
                "absorb_kernel", "merkle_level_kernel", "permute_kernel")


def fri_phases(run) -> dict:
    """One more run of a FRI prove with its steps timed: each wraps its
    call in torch.cuda.synchronize() and adds its wall time to its step.
    Steps nest (a host copy inside a Merkle opening counts in both), so the
    times are inclusive and do not add up to the total."""
    from city_rollup_tpu_torch import convert
    from city_rollup_tpu_torch.core import fri, merkle
    from city_rollup_tpu_torch.core.challenger import Challenger
    steps = [
        ("commit: Merkle tree build", merkle.BatchedMerkleTree,
         "__init__"),
        ("fold (torch, gl64_ext)", fri, "_fold_codeword"),
        ("final polynomial (coset_intt + check)", fri, "_final_poly_coeffs"),
        ("grind (K3 batches)", fri, "grind"),
        ("query openings (BatchedMerkleTree.prove)",
         merkle.BatchedMerkleTree, "prove"),
        ("challenger duplex (host Poseidon)", Challenger, "_duplex"),
        ("copies to the host (convert.to_u64)", convert, "to_u64")]
    totals = {name: 0.0 for name, _, _ in steps}
    saved = []

    def timed(name, fn):
        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                torch.cuda.synchronize()
                totals[name] += (time.perf_counter() - t) * 1e3
        return wrapper

    for name, owner, attr in steps:
        fn = getattr(owner, attr)
        saved.append((owner, attr, fn))
        setattr(owner, attr, timed(name, fn))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        totals["total"] = (time.perf_counter() - t0) * 1e3
    finally:
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)
    return totals


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="profile_out")
    ap.add_argument("--only", nargs="+", metavar="TAG")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_commit: CUDA is not available", file=sys.stderr)
        return 1
    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root))
    from city_rollup_tpu_torch import _build, convert, pipeline
    from city_rollup_tpu_torch.core import fri, ntt
    from city_rollup_tpu_torch.core.challenger import Challenger
    from city_rollup_tpu_torch.snark import (CircuitBuilder, CircuitConfig,
                                             minifier, prover, recursion)
    import chip_smoke as cs

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "--id=0"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print(card, flush=True)
    _build.build()
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    results = {}

    def rand(shape):
        return convert.from_u64(
            rng.integers(0, P, size=shape, dtype=np.uint64), dev)

    def commit(fn, log_n):
        x = rand((64, 1 << log_n))
        return lambda: fn(x, log_n=log_n, rate_bits=3, cap_height=4)

    def fri_prove(log_n):
        cfg = fri.FriConfig()
        cw = tuple(ntt.coset_lde(rand((1 << log_n,)), log_n, cfg.rate_bits)
                   for _ in range(2))
        return lambda: fri.fri_prove(cw, log_n + cfg.rate_bits, 7, cfg,
                                     Challenger())

    def prove_batch():
        b, paths, data = cs.full_width_circuit(CircuitBuilder, CircuitConfig)

        def run(on_step=None):
            pws = [cs.merkle_paths_witness(b, paths, seed)
                   for seed in range(1, cs.PROVE_BATCH + 1)]
            return prover.prove_batch(data, pws, on_step=on_step)
        return run

    def wrap_prove():
        b, paths, data = cs.full_width_circuit(CircuitBuilder, CircuitConfig)
        leaf = prover.prove(data, cs.merkle_paths_witness(b, paths, 0))
        wrap, witness = cs.wrapper_of(data, minifier, recursion)

        def run(on_step=None):
            return prover.prove_batch(wrap.data, [witness(leaf)],
                                      on_step=on_step)
        return run

    for name, tag, make in [
            ("lde_commit 2^20 x 64", "lde_commit_20",
             lambda: commit(pipeline.lde_commit, 20)),
            ("lde_commit_streamed 2^22 x 64", "lde_commit_streamed_22",
             lambda: commit(pipeline.lde_commit_streamed, 22)),
            ("fri_prove log_m 23", "fri_prove_23", lambda: fri_prove(20)),
            ("prove_batch B=8 log_n 12", "prove_batch_8", prove_batch),
            ("wrap prove log_n 15", "wrap_prove_15", wrap_prove)]:
        if args.only and tag not in args.only:
            continue
        run = make()
        run()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        phases = fri_phases(run) if tag.startswith("fri") else None
        if tag.startswith(("prove", "wrap")):
            timer = cs.StepTimer()
            timer.start()
            run(on_step=timer)
            phases = {k: v * 1e3 for k, v in timer.steps.items()}
            phases["total"] = sum(phases.values())
        del run
        kernels = [(e.key, e.count, _device_us(e) / 1e3)
                   for e in prof.key_averages() if _is_kernel(e)]
        kernels.sort(key=lambda k: -k[2])
        busy_ms = sum(k[2] for k in kernels)
        if busy_ms <= 0:
            raise RuntimeError("the profiler recorded no device time")
        # copies between host and device run on the copy engines
        copy_ms = sum(k[2] for k in kernels if k[0].startswith("Memcpy"))
        trace = out_dir / f"trace_{tag}.json"
        prof.export_chrome_trace(str(trace))
        print(f"{name}: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms "
              f"(of it copies {copy_ms:.3f} ms), idle share "
              f"{1 - busy_ms / wall_ms:.4f}", flush=True)
        for key, count, ms in kernels[:15]:
            print(f"  {ms:10.3f} ms {ms / busy_ms:7.2%} x{count:<5} "
                  f"{key[:100]}", flush=True)
        # every device kernel that is not the port's own: what the NTT and
        # the hashes still leave to torch (gathers, copies, limb ops)
        torch_ops = [k for k in kernels
                     if not any(p in k[0] for p in PORT_KERNELS)]
        torch_ms = sum(k[2] for k in torch_ops)
        print(f"  torch ops: {len(torch_ops)} kinds, "
              f"{sum(k[1] for k in torch_ops)} launches, {torch_ms:.3f} ms",
              flush=True)
        for key, count, ms in torch_ops:
            print(f"    {ms:10.3f} ms x{count:<5} {key[:100]}", flush=True)
        results[name] = {
            "wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "copy_ms": copy_ms, "idle_share": 1 - busy_ms / wall_ms,
            "torch_ops_ms": torch_ms,
            "torch_ops": [{"name": k[:100], "count": c, "ms": ms}
                          for k, c, ms in torch_ops],
            "kernels": [{"name": k[:100], "count": c, "ms": ms}
                        for k, c, ms in kernels[:15]]}
        if phases:
            print(f"{name} without the profiler, by step (wall ms; each "
                  f"step synchronises the device at its ends; FRI's steps "
                  f"nest, so they are inclusive):", flush=True)
            for step, ms in phases.items():
                print(f"  {ms:10.3f} ms  {step}", flush=True)
            results[name]["steps_ms"] = phases
    print(card, flush=True)
    print(json.dumps(results), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
