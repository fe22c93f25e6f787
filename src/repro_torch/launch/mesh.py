"""Mesh construction over the process group's devices.

Counterpart of ``repro/launch/mesh.py``.  Functions, not module-level
constants, so importing this module never touches device or process-group
state.  Single-pod: (16, 16) = 256 devices, axes (data, model).  Multi-pod:
(2, 16, 16) = 512 devices, axes (pod, data, model); the pod axis composes
with data for the batch dimension, model parallelism stays inside a pod.

A mesh is a ``torch.distributed`` ``DeviceMesh`` with named dims, one rank
per device.  A process group already started is used; under ``torchrun``
(``WORLD_SIZE`` and ``MASTER_ADDR`` set) the group of its world is started
from that environment; in a plain process, one of world size 1 from an
in-memory ``HashStore`` (no TCP port, no network).  ``device=None`` means
the card (NCCL) and raises without one; ``device="cpu"`` means gloo.
"""
from __future__ import annotations

import os

import torch

__all__ = ["make_production_mesh", "make_local_mesh"]


def _device_type(device) -> str:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' for a gloo mesh on the host")
        return "cuda"
    dtype = torch.device(device).type
    if dtype == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' requested but CUDA is not available")
    return dtype


def _torchrun() -> bool:
    return "WORLD_SIZE" in os.environ and "MASTER_ADDR" in os.environ


def _world_size() -> int:
    """The running group's size; else torchrun's ``WORLD_SIZE``; else 1."""
    import torch.distributed as dist

    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ["WORLD_SIZE"]) if _torchrun() else 1


def _join(dtype: str) -> None:
    """Start the process group when none exists: torchrun's, or one of
    world size 1 (``HashStore``).  On the card each rank takes the device of
    its ``LOCAL_RANK`` (0 without one)."""
    import torch.distributed as dist

    if dist.is_initialized():
        return
    backend, kw = "gloo", {}
    if dtype == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
        backend, kw = "nccl", {"device_id": dev}
    if _torchrun():
        dist.init_process_group(backend, **kw)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, **kw)


def _mesh(device, shape: tuple[int, ...], names: tuple[str, ...]):
    from torch.distributed.device_mesh import init_device_mesh

    dtype = _device_type(device)
    need = 1
    for s in shape:
        need *= s
    have = _world_size()
    if need != have:
        raise ValueError(f"a {shape} mesh {names} needs {need} ranks; the "
                         f"process group has {have}")
    _join(dtype)
    return init_device_mesh(dtype, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """The (16, 16) ``(data, model)`` mesh, or (2, 16, 16) ``(pod, data,
    model)``; ``ValueError`` unless the process group has exactly that many
    ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(device, shape, axes)


def make_local_mesh(data: int | None = None, model: int = 1, device=None):
    """``(data, model)`` mesh over whatever ranks exist (tests, smoke runs,
    examples): one rank and one device without ``torchrun``."""
    _device_type(device)
    if data is None:
        data = _world_size() // model
    return _mesh(device, (data, model), ("data", "model"))
