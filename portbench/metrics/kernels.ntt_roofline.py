"""The NTT kernels' share of their roofline over the window, in %: the
least time of every call into ``cuda_ntt``'s public entries (bytes bound,
``bounds.ntt_bound_s`` of each call's shapes) over the device time of the
profiler's ``ntt_*`` kernels. Nothing to read without device time."""

import re

from portbench import bounds

KERNEL = re.compile(r"\bntt_\w*kernel")


def install(prog, probes):
    """Add each call's bound on a CUDA tensor to counters["ntt_bound_s"]."""
    def counted(bound):
        def make(fn):
            def wrapped(x, *args, **kwargs):
                if x.is_cuda:
                    probes.counters["ntt_bound_s"] += bound(x, *args,
                                                            **kwargs)
                    probes.counters["ntt_calls"] += 1
                return fn(x, *args, **kwargs)
            return wrapped
        return make

    def rows(x):
        return x.numel() // x.shape[-1]

    def square(x, log_n, *a, **k):
        return bounds.ntt_bound_s(rows(x), 1 << log_n, 1 << log_n)

    def lde(x, log_n, rate_bits, *a, **k):
        return bounds.ntt_bound_s(rows(x), 1 << log_n,
                                  1 << (log_n + rate_bits))

    n = prog.cuda_ntt
    for entry, bound in (("ntt", square), ("intt", square),
                         ("coset_lde", lde), ("coset_intt", square)):
        probes.patch(n, entry, counted(bound))


def read(run):
    if not run.events or not run.counters.get("ntt_calls"):
        return None
    device_s = sum(e - s for name, s, e in run.events
                   if KERNEL.search(name)) * 1e-9
    if not device_s:
        return None
    return 100.0 * run.counters["ntt_bound_s"] / device_s
