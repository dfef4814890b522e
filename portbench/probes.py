"""What a traced run (``--trace 1``) records, from outside the program:
wrappers installed at run time around the program's entries, and the
profiler's device timeline.

- Host spans: the worker's and the prover's steps (``generate_witness``,
  ``quotient_coeffs`` with the device synchronised at both ends,
  ``prove_batch``, openings, FRI, the store's encoding, the witness
  preparation), each kept with its wall-clock ends (the profiler's time
  base). They name the idle gaps of the breakdown, and metrics read them.
- Counters: ``counters[name]``, which a metric's own ``install(prog,
  probes)`` fills through ``patch`` (the kernel rooflines add each call's
  bound there).
- The device timeline: ``torch.profiler`` (device activity only, so that
  the host's steps are not slowed by recording every operator) over the
  window: every device event, busy time (the union of kernels, copies and
  memsets) and the idle gaps, each named by the innermost host step it
  fell in.

Nothing of this is installed in an untraced run.
"""

from __future__ import annotations

import collections
import contextlib
import time

import torch


class Probes:
    def __init__(self, cuda: bool):
        self.cuda = cuda
        self.host_s = collections.defaultdict(float)
        self.counters = collections.defaultdict(float)
        self.spans: list = []       # (start ns, end ns, label), wall clock
        self._undo: list = []

    # -- installing ------------------------------------------------------------
    def patch(self, owner, name: str, make):
        """Replace owner.name by make(owner.name) until uninstall()."""
        old = getattr(owner, name)
        setattr(owner, name, make(old))
        self._undo.append((owner, name, old))

    def span(self, label: str, sync: bool = False):
        """A wrapper that times the call into host_s[label] and keeps its
        span for the idle-gap breakdown."""
        def make(fn):
            def wrapped(*args, **kwargs):
                if sync and self.cuda:
                    torch.cuda.synchronize()
                n0, t0 = time.time_ns(), time.perf_counter()
                try:
                    return fn(*args, **kwargs)
                finally:
                    if sync and self.cuda:
                        torch.cuda.synchronize()
                    self.host_s[label] += time.perf_counter() - t0
                    self.spans.append((n0, time.time_ns(), label))
            return wrapped
        return make

    def install(self, prog) -> None:
        """`prog`: the program's modules (``harness.Program``)."""
        p = self.patch
        p(prog.prover, "generate_witness", self.span("witness"))
        p(prog.device_passes, "quotient_coeffs",
          self.span("quotient", sync=True))
        p(prog.prover, "prove_batch", self.span("prove_batch"))
        p(prog.prover, "ext_eval_batch", self.span("openings"))
        p(prog.fri, "fri_prove_batch", self.span("fri"))
        p(prog.worker, "encode_proof", self.span("encode_proof"))
        p(prog.worker, "decode_witness", self.span("decode_witness"))
        for m in ("prepare_op", "prepare_dummy"):
            p(prog.circuits.CircuitToolbox, m, self.span("prepare"))

    def uninstall(self) -> None:
        for owner, name, old in reversed(self._undo):
            setattr(owner, name, old)
        self._undo.clear()

    # -- the profiler ------------------------------------------------------------
    @contextlib.contextmanager
    def profile(self):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            yield prof
        self.prof = prof


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def timeline(prof, t0_ns: int, t1_ns: int, spans: list) -> dict:
    """Every device event as (name, start ns, end ns), the ten names with
    the most device time, busy seconds, and idle seconds by the host step
    (`spans`) they fell in, over the window [t0_ns, t1_ns] (wall clock, the
    profiler's time base)."""
    device, events = [], []
    by_name = collections.defaultdict(float)
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda:
            s, d = e.start_ns(), e.duration_ns()
            device.append((s, s + d))
            by_name[e.name()] += d * 1e-9
            events.append((e.name(), s, s + d))
    busy = _merge([(max(s, t0_ns), min(e, t1_ns)) for s, e in device
                   if e > t0_ns and s < t1_ns])
    busy_s = sum(e - s for s, e in busy) * 1e-9
    gaps, cur = [], t0_ns
    for s, e in busy:
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if t1_ns > cur:
        gaps.append((cur, t1_ns))
    notes = sorted(spans)
    idle = collections.defaultdict(float)
    for s, e in gaps:
        mid = (s + e) // 2
        inner = "worker"
        for ns, ne, name in notes:
            if ns > mid:
                break
            if ne >= mid:
                inner = name            # the latest-starting cover: innermost
        idle[inner] += (e - s) * 1e-9
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    first = min((s for s, _ in device), default=t0_ns)
    last = max((e for _, e in device), default=t1_ns)
    return {"busy_s": busy_s, "events": events,
            "device_ops": [[k[:160], v] for k, v in top],
            "idle_gaps": [[k, v] for k, v in
                          sorted(idle.items(), key=lambda kv: -kv[1])[:10]],
            # device activity before the window opened and after it closed
            # (0 and 0 where the two clocks agree and the window is whole)
            "outside_s": [max(0, t0_ns - first) * 1e-9,
                          max(0, last - t1_ns) * 1e-9]}
