"""The device mesh of the proving fleet, and the two moves between a global
tensor and this rank's block of it.

Counterpart of the reference's ``parallel/mesh.py``: one flat axis ``"x"``
carries whichever tensor axis a call shards (the LDE's evaluation axis, the
poly axis, the proof batch axis). ``make_mesh`` needs a default process
group that is already set up, by the caller (``init_process_group``) or by
``torchrun``'s environment; it never sets one up itself.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def make_mesh(n_devices: int | None = None, axis: str = "x",
              device=None) -> DeviceMesh:
    """A 1-D mesh over every rank of the default group, its dim named
    ``axis``. The default device type is CUDA (the group's backend must
    be NCCL; rank r uses ``cuda:LOCAL_RANK``); ``device="cpu"`` asks for a
    CPU mesh over gloo."""
    if not dist.is_initialized():
        raise RuntimeError(
            "no default process group: call torch.distributed."
            "init_process_group (or run under torchrun) before make_mesh")
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"asked for {n_devices} devices, but the process "
                         f"group has {world} ranks")
    kind = torch.device("cuda" if device is None else device).type
    backend = str(dist.get_backend())
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a CUDA mesh needs a GPU, and CUDA is not "
                               "available; pass device='cpu' for gloo")
        if "nccl" not in backend:
            raise ValueError(f"a CUDA mesh needs an NCCL group, not "
                             f"{backend!r}")
        torch.cuda.set_device(int(os.environ.get(
            "LOCAL_RANK", dist.get_rank() % torch.cuda.device_count())))
    elif kind == "cpu":
        if "gloo" not in backend:
            raise ValueError(f"a CPU mesh needs a gloo group, not "
                             f"{backend!r}")
    else:
        raise ValueError(f"unsupported device {device!r}")
    return init_device_mesh(kind, (world,), mesh_dim_names=(axis,))


def group(mesh: DeviceMesh):
    """The process group of the mesh's one axis."""
    return mesh.get_group(mesh.mesh_dim_names[0])


def rank(mesh: DeviceMesh) -> int:
    return dist.get_rank(group(mesh))


def size(mesh: DeviceMesh) -> int:
    return dist.get_world_size(group(mesh))


def device(mesh: DeviceMesh) -> torch.device:
    """The device this rank's tensors live on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def shard(mesh: DeviceMesh, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """This rank's contiguous block of ``x`` along ``dim`` (a view)."""
    d = size(mesh)
    n = x.shape[dim]
    if n % d:
        raise ValueError(f"an axis of {n} does not split over {d} devices")
    return x.narrow(dim, rank(mesh) * (n // d), n // d)


def gather(mesh: DeviceMesh, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """The global tensor whose blocks along ``dim`` are every rank's ``x``,
    in rank order (one all-gather), on every rank."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(size(mesh))]
    dist.all_gather(parts, x, group=group(mesh))
    return torch.cat(parts, dim=dim)
