"""Jobs per prove_batch call over the window, from the worker's own
counter ``Worker.batched_groups`` (one entry per same-circuit group it
proved together). Nothing to read where the worker proves one job a call
(``process_next_job`` appends nothing)."""


def read(run):
    groups = run.program.get("batched_groups")
    return sum(groups) / len(groups) if groups else None
