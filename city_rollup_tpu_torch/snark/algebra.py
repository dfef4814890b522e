"""Evaluation algebras: one gate-constraint definition, several backends.

Counterpart of the reference's ``snark/algebra.py``. Every gate expresses
its constraints once against this small interface; the prover evaluates
them over the LDE domain (``TorchAlg``: int64 tensors, on the device the
tensors live on), the host verifier at one extension point (``HostExtAlg``:
python ints).

Interface (elements are backend-specific):
  add(a, b), sub(a, b), mul(a, b)         -- ring ops
  cmul(c, x), cadd(c, x)                  -- literal-int constant * / +
  const_like(c, like)                     -- lift a literal int near `like`
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import gl64, gl64_ext

P = gl64.P


class HostExtAlg:
    """Extension-field points as (int, int) tuples — exact host math."""
    add = staticmethod(gl64_ext.h_add)
    sub = staticmethod(gl64_ext.h_sub)
    mul = staticmethod(gl64_ext.h_mul)

    @staticmethod
    def cmul(c, x):
        c = c % P
        return ((c * x[0]) % P, (c * x[1]) % P)

    @staticmethod
    def cadd(c, x):
        return ((x[0] + c) % P, x[1])

    @staticmethod
    def const_like(c, like):
        return (c % P, 0)


def _lit(c) -> int:
    """A literal int as the int64 bit pattern of its canonical value, an
    operand the gl64 ops broadcast like a 0-d tensor."""
    return gl64.to_i64(int(c) % P)


class TorchAlg:
    """Base-field int64 tensors over the LDE domain, of any shapes that
    broadcast together ((M,) columns against (B, M) ones, (B, 1) challenge
    columns against both). Backs the prover's constraint pass
    (snark/device_passes.py)."""
    add = staticmethod(gl64.add)
    sub = staticmethod(gl64.sub)
    mul = staticmethod(gl64.mul)

    @staticmethod
    def cmul(c, x):
        return gl64.mul(x, _lit(c))

    @staticmethod
    def cadd(c, x):
        return gl64.add(x, _lit(c))

    @staticmethod
    def const_like(c, like):
        return like.new_full((), _lit(c)).expand(like.shape)


def lift_torch(v, like: torch.Tensor) -> torch.Tensor:
    """Literal int, or per-batch (B,) values (numpy array or tensor) -> an
    int64 tensor on `like`'s device that broadcasts against (M,) or (B, M)
    domain tensors: a 0-d tensor, or a (B, 1) column."""
    if isinstance(v, (np.ndarray, torch.Tensor)):
        if isinstance(v, np.ndarray):
            v = torch.from_numpy(
                np.ascontiguousarray(v, dtype=np.uint64).view(np.int64))
        return v.to(like.device).reshape(-1, 1)
    return like.new_full((), _lit(v))


def lift_host(v: int):
    return (v % P, 0)
