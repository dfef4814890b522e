"""The Poseidon kernels' share of their roofline over the window, in %: the
least time of every call into ``cuda_poseidon``'s ``permute_t``,
``sponge_t``, ``reduce_level_t`` and ``absorb_t`` (``bounds.py``) over the
device time of the profiler's permute, sponge, merkle_level and absorb
kernels. Nothing to read without device time."""

import re

from portbench import bounds

KERNEL = re.compile(r"\b(permute|sponge|absorb|merkle_level)_kernel")


def install(prog, probes):
    """Add each call's bound on a CUDA tensor to
    counters["poseidon_bound_s"]."""
    def counted(bound):
        def make(fn):
            def wrapped(x, *args, **kwargs):
                if x.is_cuda:
                    probes.counters["poseidon_bound_s"] += bound(
                        x, *args, **kwargs)
                    probes.counters["poseidon_calls"] += 1
                return fn(x, *args, **kwargs)
            return wrapped
        return make

    c = prog.cuda_poseidon
    for entry, bound in (
            ("permute_t", lambda s, *a, **k: bounds.permute_bound_s(
                s.shape[1])),
            ("sponge_t", lambda x, *a, **k: bounds.sponge_bound_s(*x.shape)),
            ("reduce_level_t", lambda d, *a, **k: bounds.level_bound_s(
                d.shape[1] // 2)),
            ("absorb_t", lambda s, ch, *a, **k: bounds.absorb_bound_s(
                ch.shape[0], s.shape[1]))):
        probes.patch(c, entry, counted(bound))


def read(run):
    if not run.events or not run.counters.get("poseidon_calls"):
        return None
    device_s = sum(e - s for name, s, e in run.events
                   if KERNEL.search(name)) * 1e-9
    if not device_s:
        return None
    return 100.0 * run.counters["poseidon_bound_s"] / device_s
