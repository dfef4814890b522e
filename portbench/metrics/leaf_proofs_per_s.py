"""Leaf jobs proven and written to the store over the window's whole time:
the first call's start to the last call's end (no call starts after
``--seconds``)."""


def read(run):
    if not run.window_s:
        return None
    return sum(c.done for c in run.calls) / run.window_s
