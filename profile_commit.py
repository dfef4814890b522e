#!/usr/bin/env python3
"""Where the device time of the two commits goes, on one GPU.

    python3 profile_commit.py [--out DIR]

Runs lde_commit at 2^20 x 64 and lde_commit_streamed at 2^22 x 64
(rate_bits 3, cap_height 4) of the PyTorch/CUDA port once each to warm up,
then once each under torch.profiler. For each commit it prints the wall
time, the summed device time of its kernels (one stream, so the kernels do
not overlap), the device's idle share, and the kernels by device time, and
writes the Chrome trace to DIR (default profile_out/). The last line is one
JSON object with the same numbers. It fails without CUDA.
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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="profile_out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_commit: CUDA is not available", file=sys.stderr)
        return 1
    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root))
    from city_rollup_tpu_torch import _build, convert, pipeline

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
    for name, fn, log_n in [
            ("lde_commit 2^20 x 64", pipeline.lde_commit, 20),
            ("lde_commit_streamed 2^22 x 64", pipeline.lde_commit_streamed,
             22)]:
        x = convert.from_u64(
            rng.integers(0, P, size=(64, 1 << log_n), dtype=np.uint64), dev)
        kw = dict(log_n=log_n, rate_bits=3, cap_height=4)
        fn(x, **kw)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn(x, **kw)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        del x
        kernels = [(e.key, e.count, _device_us(e) / 1e3)
                   for e in prof.key_averages() if _is_kernel(e)]
        kernels.sort(key=lambda k: -k[2])
        busy_ms = sum(k[2] for k in kernels)
        if busy_ms <= 0:
            raise RuntimeError("the profiler recorded no device time")
        trace = out_dir / f"trace_{name.split()[0]}_{log_n}.json"
        prof.export_chrome_trace(str(trace))
        print(f"{name}: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms, "
              f"idle share {1 - busy_ms / wall_ms:.4f}", flush=True)
        for key, count, ms in kernels[:15]:
            print(f"  {ms:10.3f} ms {ms / busy_ms:7.2%} x{count:<5} "
                  f"{key[:100]}", flush=True)
        results[name] = {
            "wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "idle_share": 1 - busy_ms / wall_ms,
            "kernels": [{"name": k[:100], "count": c, "ms": ms}
                        for k, c, ms in kernels[:15]]}
    print(card, flush=True)
    print(json.dumps(results), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
