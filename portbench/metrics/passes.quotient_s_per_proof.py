"""Seconds in ``device_passes.quotient_coeffs``, the device synchronised at
both ends (the probes' ``quotient`` span), per proof over the window."""


def read(run):
    s = run.host_s.get("quotient")
    proofs = sum(c.done for c in run.calls)
    return s / proofs if s is not None and proofs else None
