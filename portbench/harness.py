"""One run of one cell: set-up, the measured window, the traced run's
readings, the check against the plain reference, and the result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

The cell's traffic names its kind of work (``work/<name>.py``), which sets up
the work: for the rollup's leaf level, the configuration's shape family
and the traffic's blocks, planned by the program's orchestrator into its
in-memory proof store. Set-up ends with the work's first call, which
warms the cell's shape. The window then repeats the work's call until
``--seconds`` have passed (no call starts after that; the window ends with
the last call) or the backlog is drained. Each metric is the ``read(run)``
of ``metrics/<name>.py``; a reader that sets ``TIMELINE = True`` has the
profiler's device timeline over the window in untraced runs too. After the window the program's state is freed
and the work's check against the plain reference (``ref/judge.py``)
reads what the window wrote.
"""

from __future__ import annotations

import dataclasses
import contextlib
import gc
import json
import os
import sys
import time
import types
from pathlib import Path

from . import manifest

FORBIDDEN = ("jax", "jaxlib", "flax", "city_rollup_tpu")
PROGRAM = "city_rollup_tpu_torch"


class NoDevice(RuntimeError):
    pass


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (the port's own name begins with the JAX package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} &
                  set(FORBIDDEN))


def cache_dirs(root: Path) -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    base = root / ".portbench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        path = base / sub
        path.mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(path)
    os.environ.setdefault("USE_FLAX", "0")


class Program:
    """The program's modules the harness drives."""

    def __init__(self):
        import importlib
        pkg = PROGRAM
        for attr, mod in [
                ("build", "_build"), ("circuits", "rollup.circuits"),
                ("op_circuits", "rollup.op_circuits"),
                ("orchestrator", "rollup.orchestrator"),
                ("city_store", "rollup.city_store"),
                ("proof_store", "rollup.proof_store"),
                ("queues", "rollup.queues"), ("worker", "rollup.worker"),
                ("prover", "snark.prover"),
                ("device_passes", "snark.device_passes"),
                ("config", "snark.config"), ("fri", "core.fri"),
                ("cuda_ntt", "core.cuda_ntt"),
                ("cuda_poseidon", "core.cuda_poseidon")]:
            setattr(self, attr, importlib.import_module(f"{pkg}.{mod}"))

    def params(self, cfg: dict):
        cc = dict(cfg["circuit_config"])
        fri = self.fri.FriConfig(**cc.pop("fri"))
        config = self.config.CircuitConfig(fri=fri, **cc)
        return self.op_circuits.RollupParams(config=config,
                                             **cfg["rollup_params"])


HOST_CPUS = 4
CARD_QUERY = ("clocks.sm,clocks.mem,power.draw,power.limit,temperature.gpu,"
              "clocks_throttle_reasons.active")


def pin_host() -> list[int]:
    """Keep the run on a fixed set of the host's cores, with as many torch
    threads: load from one process with few threads. The last cores are
    taken, as the first tend to serve the machine's interrupts."""
    import torch
    cpus = sorted(os.sched_getaffinity(0))[-HOST_CPUS:]
    os.sched_setaffinity(0, cpus)
    torch.set_num_threads(len(cpus))
    return cpus


def host_speed() -> float:
    """Seconds of a fixed loop of host python: read before and after the
    window, it shows whether the host's speed moved during a run."""
    t = time.perf_counter()
    x = 0
    for i in range(1_000_000):
        x = (x * 31 + i) % 1_000_003
    return time.perf_counter() - t


def card_state() -> dict | None:
    """The card's clocks, power and throttle reasons (``nvidia-smi``, read
    outside the window), or None where it cannot be read."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "-i", "0", f"--query-gpu={CARD_QUERY}",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return dict(zip(CARD_QUERY.split(","),
                    (v.strip() for v in out.stdout.split(","))))


@dataclasses.dataclass
class Call:
    t0: float
    t1: float
    done: int


def _window_part(before: dict, after: dict) -> dict:
    """What a counter gained over the window: a list's new entries, a
    number's increase."""
    out = {}
    for k, v in after.items():
        b = before.get(k)
        out[k] = v[len(b):] if isinstance(v, list) else v - b
    return out


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             t_start: float, root: Path, device=None, base: Path = None,
             mutate=None, cache: dict | None = None) -> dict:
    """One run; returns the result dict (its "checks" last).

    `device`: None for the card (the run needs as many as the cell asks
    for); "cpu" only from the tests. `mutate(prog, work)`: a fault or
    control planted in the program after its set-up (tests and
    ``control.py``); returns its undo. `cache`: kept across runs in one
    process (the family builds), for ``control.py``'s seeds."""
    import torch

    base = base or manifest.HERE
    cell = manifest.cell(manifest.load(root), name, base)
    cfg, mix = cell.config, cell.traffic
    chips = int(cell.workload["chips"])
    cuda = device is None
    cpus = None
    if cuda:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < chips:
            raise NoDevice(f"the cell needs {chips} CUDA device(s); "
                           f"available: {torch.cuda.is_available()}, "
                           f"count: {torch.cuda.device_count()}")
        device = "cuda"
        cache_dirs(root)
        cpus = pin_host()
    cache = {} if cache is None else cache

    prog = Program()
    if cuda:
        prog.build.build()
    ctx = types.SimpleNamespace(prog=prog, cfg=cfg, mix=mix, seed=seed,
                                device=device, cache=cache)
    work = manifest.work(mix["work"], base).start(ctx)
    undo = mutate(prog, work) if mutate is not None else None

    # warm-up: the backlog's first call, at the cell's shape
    work.call()
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    n_warm = work.jobs_popped()

    speed = [host_speed()]
    card = [card_state()] if cuda else None
    # the metrics this run reports; a reader with TIMELINE = True needs the
    # profiler's device timeline, in an untraced run too
    readers = {m["name"]: manifest.metric(m["name"], base)
               for m in (cell.per_layer if trace else cell.end_to_end)}
    timeline_on = cuda and (trace or any(
        getattr(r, "TIMELINE", False) for r in readers.values()))
    probes = None
    if trace or timeline_on:
        from .probes import Probes
        probes = Probes(cuda)
    if trace:
        probes.install(prog)
        for r in readers.values():
            install = getattr(r, "install", None)
            if install is not None:
                install(prog, probes)
    peak_setup = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    counters0 = work.counters()
    calls = []
    with contextlib.ExitStack() as stack:
        if probes:
            stack.callback(probes.uninstall)
        if timeline_on:
            stack.enter_context(probes.profile())
        w0_ns = time.time_ns()
        w0 = time.perf_counter()
        while time.perf_counter() - w0 < seconds and work.pending():
            c0 = time.perf_counter()
            done = work.call()
            if cuda:
                torch.cuda.synchronize()
            calls.append(Call(c0, time.perf_counter(), done))
        w1_ns = time.time_ns()
    window_s = (calls[-1].t1 - calls[0].t0) if calls else 0.0
    peak_window = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        card.append(card_state())
    speed.append(host_speed())

    tl, trace_s = {}, None
    if timeline_on:
        from .probes import timeline
        t_tl = time.perf_counter()
        tl = timeline(probes.prof, w0_ns, w1_ns, probes.spans)
        trace_s = time.perf_counter() - t_tl
    run = types.SimpleNamespace(
        setup_s=setup_s, window_s=window_s, calls=calls,
        trace_window_s=(w1_ns - w0_ns) * 1e-9,
        program=_window_part(counters0, work.counters()),
        spans=probes.spans if probes else [],
        host_s=dict(probes.host_s) if probes else {},
        counters=dict(probes.counters) if probes else {},
        events=tl.get("events"), busy_s=tl.get("busy_s"),
        peak_window_bytes=peak_window if cuda else None)
    metrics = {}
    for m in cell.per_layer if trace else cell.end_to_end:
        value = readers[m["name"]].read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": chips if cuda else 0,
                   "memory_peak_bytes": max(peak_setup, peak_window)}
    breakdown = None
    if trace and tl:
        device_info["busy_s"] = tl["busy_s"]
        device_info["window_s"] = run.trace_window_s
        breakdown = {"device_ops": tl["device_ops"],
                     "idle_gaps": tl["idle_gaps"]}

    # the outputs to judge: every job the worker was asked for
    outputs = work.outputs(n_warm)
    record = {"calls": len(calls), "proven": sum(c.done for c in calls),
              "window_s": window_s, "warm_jobs": n_warm,
              "backlog_left": work.backlog_left(),
              "call_s": [round(c.t1 - c.t0, 4) for c in calls],
              "host_speed_s": speed, "card": card, "cpus": cpus}
    if tl:
        record.update(trace_read_s=trace_s,
                      device_events=len(tl["events"]),
                      device_outside_s=tl["outside_s"])
    if undo is not None:
        undo()
    work.free()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    checks = work.judge(outputs, (root / ".portbench_cache" /
                                     "reference") if cuda else None)
    record["check_s"] = time.perf_counter() - t_check
    failed_jobs = checks.pop("_failed_jobs")
    record["verified"] = checks.pop("_verified", None)
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    failed = sum(o["job"] in failed_jobs for o in outputs if o["in_window"])
    result = {"correct": bool(correct),
              "attempted": sum(o["in_window"] for o in outputs),
              "failed": failed, "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    # the window's record, for reading a run by hand
    result["window"] = record
    result["checks"] = checks
    return result


def main(argv=None, t_start: float | None = None) -> int:
    import argparse
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = manifest.HERE.parent
    try:
        result = run_cell(args.workload, args.seed, args.seconds,
                          bool(args.trace), t_start, root)
    except NoDevice as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 3
    found = forbidden_modules()
    if found:
        print("portbench: loaded modules of JAX or the JAX package: " +
              ", ".join(found), file=sys.stderr)
        return 4
    w = result["window"]
    print(f"host_speed_s before {w['host_speed_s'][0]:.4f} after "
          f"{w['host_speed_s'][1]:.4f}; card {w['card']}; cpus {w['cpus']}",
          file=sys.stderr)
    for name, c in result["checks"].items():
        if "limit" in c:
            print(f"check {name} {c['value']} limit {c['limit']}",
                  file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
