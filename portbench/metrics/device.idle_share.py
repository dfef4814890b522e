"""The share of the traced window in which no kernel, copy or memset ran
on the device, in % (the profiler's timeline)."""


def read(run):
    if run.busy_s is None or not run.trace_window_s:
        return None
    return 100.0 * (1.0 - run.busy_s / run.trace_window_s)
