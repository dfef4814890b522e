"""Leaf jobs proven and written to the store over the traced window's
whole time (``leaf_proofs_per_s``'s reading), in the cells where the rate
on the host's clock is too unsteady to be held to a bound end to end: there
it is a per-layer metric, read in a traced run, and the end-to-end metric
is ``leaf_device_s_per_proof``."""

from portbench import manifest

read = manifest.metric("leaf_proofs_per_s").read
