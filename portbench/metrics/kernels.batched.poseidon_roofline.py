"""`kernels.poseidon_roofline` in the cells that report `leaf_device_s_per_proof` in place of
`leaf_proofs_per_s`: the same reading, under a name of its own, since a
per-layer metric moves one end-to-end metric that each of its cells
reports."""

from portbench import manifest

_base = manifest.metric("kernels.poseidon_roofline")
read = _base.read
install = getattr(_base, "install", None)
