"""The benchmark's plain reference: a frozen copy of the port's host code.

The subpackages (``core``, ``crypto``, ``snark``, ``rollup``) copy the
port's modules that build the rollup's circuits, plan blocks on the state
store and verify proofs, and only the parts of them that the check
reaches (no prover, witness generator or L1 path), with their imports
relative to this package, so that nothing here loads the port, JAX or the
JAX package. Every kernel is replaced by its plain PyTorch version:
``core/ntt.py`` runs its radix-2 transform and ``core/sponge.py`` (in
place of the kernel wrappers) the plain Poseidon sponge, on a tensor of
any device. Later changes to the port do not reach this copy. The
check that decides a run's ``correct`` is ``judge.py``.

Values are ``torch.int64`` tensors carrying the u64 bit pattern, as in
the port.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def device(dev=None) -> torch.device:
    """Resolve the device an entry point runs on.

    The default is CUDA. There is no fallback: without a GPU the caller must
    ask for the CPU explicitly (``device="cpu"``), which runs the plain
    PyTorch versions of the kernels."""
    d = torch.device("cuda" if dev is None else dev)
    if d.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels")
    if d.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {d}")
    return d
