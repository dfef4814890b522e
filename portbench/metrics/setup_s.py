"""Process start to the end of the warm-up call: kernel load (a build only
on a checkout's first run), the configuration's build, the traffic's
planning and the warm-up call."""


def read(run):
    return run.setup_s
