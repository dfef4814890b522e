"""Host seconds in ``generate_witness`` per proof over the window (the
probes' ``witness`` span)."""


def read(run):
    s = run.host_s.get("witness")
    proofs = sum(c.done for c in run.calls)
    return s / proofs if s is not None and proofs else None
