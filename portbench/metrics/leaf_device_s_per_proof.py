"""Device seconds per leaf job proven and written to the store: the time
over the window in which a kernel, copy or memset ran on the device (the
union of the profiler's device events), over the jobs the window's calls
completed. Every call is synchronised before the next starts, so the
window holds all the device work of its calls and no other."""

# the harness runs the profiler over the window of every run that reports
# this metric, untraced runs too
TIMELINE = True


def read(run):
    proofs = sum(c.done for c in run.calls)
    if not run.busy_s or not proofs:
        return None
    return run.busy_s / proofs
