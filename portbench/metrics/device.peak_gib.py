"""The device memory peak over the window, in GiB:
``max_memory_allocated`` after ``reset_peak_memory_stats`` at the window's
start."""


def read(run):
    if not run.peak_window_bytes:
        return None
    return run.peak_window_bytes / 2 ** 30
