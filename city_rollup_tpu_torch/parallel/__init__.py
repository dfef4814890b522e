"""Multi-device proving over ``torch.distributed``: a 1-D device mesh, the
distributed four-step NTT and coset LDE, the sharded Merkle cap, the fused
LDE + commit, and (in ``snark/prover.py``) ``prove_batch(mesh=...)``.

Counterpart of the reference's ``parallel/`` (``jax.sharding`` +
``shard_map``), in SPMD form: one process per device, NCCL between CUDA
devices, gloo between CPU ranks (the tests'). Every rank calls each function
with the same global input and gets back its own contiguous block of the
output (or, for a cap, the whole replicated cap). The local transforms and
hashes are the single-device ones, so on CUDA they launch the NTT kernels
(K1, K2) and the sponge kernel (K4).
"""
