"""city_rollup_tpu_torch — the PyTorch/CUDA port of city_rollup_tpu.

The JAX package beside it (``city_rollup_tpu/``) is the reference: every
function here computes what its namesake there computes, bit for bit. This
package imports ``torch`` and never ``jax``.

Goldilocks values are held as ``torch.int64`` tensors carrying the u64 bit
pattern (a free view to and from numpy ``uint64``; see ``convert.py``). On a
CUDA tensor the hot functions launch the hand-written kernels under
``csrc/``; on a CPU tensor they run the plain PyTorch versions beside them.
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
