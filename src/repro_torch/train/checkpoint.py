"""Checkpointing with async save and atomic publish, in the reference's
on-disk format.

Counterpart of ``repro/train/checkpoint.py``.  Format: one ``state.npz``
whose keys are the state's leaf paths joined by ``//`` (in the reference's
sorted-key order) plus a JSON manifest (step, sorted key list, viewed
dtypes).  npz cannot hold bfloat16, so a bfloat16 leaf is stored as its
``uint16`` bit pattern and named ``"bfloat16"`` in the manifest's
``viewed_dtypes``.  Saves write to a temp directory and atomically rename --
a preempted save can never corrupt the latest checkpoint, and restart always
finds a complete one (the checkpoint/restart half of fault tolerance; see
:mod:`.ft`).  A checkpoint written by either package restores in the other.

Restore needs no ``ml_dtypes``: the stored ``uint16`` patterns are
reinterpreted as ``torch.bfloat16``, as :mod:`repro_torch.models.convert`
carries reference parameters.  ``like`` is a tree of tensors (``meta``
tensors will do), in place of the reference's abstract shape tree.

Checkpoints are mesh-agnostic, as the reference's: a state of DTensors is
gathered whole on every rank (a collective) and written by rank 0, and
``restore(..., shardings=)`` places each leaf on the mesh of its
:class:`~repro_torch.distributed.sharding.NamedSharding` -- so a
checkpoint written on one mesh restores onto another, or onto one device.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time

import numpy as np
import torch

from ..core.sim.replay_torch import resolve_device
from ..distributed.sharding import full, mesh_device
from ..models.layers import map_tree
from ..tree import get_leaf, leaf_paths, leaves, set_leaf

__all__ = ["save", "restore", "latest_step", "CheckpointManager"]

_SEP = "//"


def _key(path: tuple) -> str:
    return _SEP.join(f"#{p}" if isinstance(p, int) else str(p) for p in path)


def _to_savable(t: torch.Tensor) -> tuple[np.ndarray, str]:
    """A leaf as a host array npz can hold, plus the dtype name for a
    bfloat16 leaf stored as its ``uint16`` view."""
    t = full(t.detach()).to("cpu", copy=True)   # the write may run later
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    return t.numpy(), ""


def save(ckpt_dir: str, step: int, state, blocking: bool = True,
         extra: dict | None = None) -> threading.Thread | None:
    """Write state to ``<ckpt_dir>/step_<step>`` (tmp + atomic rename).

    A state holding DTensors is a collective: every rank gathers it, rank 0
    writes it, and every rank returns once it is published (``blocking`` is
    then ignored)."""
    os.makedirs(ckpt_dir, exist_ok=True)
    host = {}
    viewed: dict[str, str] = {}
    sharded = False
    for path, leaf in leaf_paths(state):       # device -> host now
        k = _key(path)
        sharded |= hasattr(leaf, "full_tensor")
        arr, dtname = _to_savable(torch.as_tensor(leaf))
        host[k] = arr
        if dtname:
            viewed[k] = dtname

    def _write():
        tmp = os.path.join(ckpt_dir, f".tmp_step_{step}_{os.getpid()}")
        final = os.path.join(ckpt_dir, f"step_{step}")
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "state.npz"), **host)
        manifest = {
            "step": step,
            "keys": sorted(host),
            "viewed_dtypes": viewed,
            "time": time.time(),
            **(extra or {}),
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)

    if sharded:
        import torch.distributed as dist

        if dist.get_rank() == 0:
            _write()
        dist.barrier()
        return None
    if blocking:
        _write()
        return None
    t = threading.Thread(target=_write, daemon=True)
    t.start()
    return t


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and os.path.exists(
            os.path.join(ckpt_dir, name, "manifest.json")
        ):
            steps.append(int(name.split("_")[1]))
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: int, like, device=None, shardings=None):
    """Load a ``like``-structured state onto ``device`` (``None``: the card,
    ``RuntimeError`` without one; pass ``device="cpu"`` for the host).

    ``shardings`` (a tree of
    :class:`~repro_torch.distributed.sharding.NamedSharding` with ``like``'s
    nesting) places each leaf as a DTensor on its mesh; ``device`` is then
    the mesh's."""
    if shardings is not None and device is None:
        device = mesh_device(leaves(shardings)[0].mesh)
    device = resolve_device(device)
    base = os.path.join(ckpt_dir, f"step_{step}")
    data = np.load(os.path.join(base, "state.npz"))
    with open(os.path.join(base, "manifest.json")) as f:
        viewed = json.load(f).get("viewed_dtypes", {})
    out = map_tree(lambda a: a, like)
    for path, _ in leaf_paths(like):
        key = _key(path)
        arr = data[key]
        if key in viewed:
            if viewed[key] != "bfloat16":
                raise ValueError(f"checkpoint leaf {key!r} has dtype "
                                 f"{viewed[key]!r}; only bfloat16 is stored "
                                 "as a bit view")
            t = torch.from_numpy(arr.view(np.int16).copy()).view(
                torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(arr, copy=True))
        t = t.to(device)
        if shardings is not None:
            t = get_leaf(shardings, path).place(t)
        if isinstance(out, dict):
            set_leaf(out, path, t)
        else:
            out = t
    return out


class CheckpointManager:
    """Keep-last-k manager with async saves for the training loop."""

    def __init__(self, ckpt_dir: str, keep: int = 3, every: int = 100):
        self.dir = ckpt_dir
        self.keep = keep
        self.every = every
        self._pending: threading.Thread | None = None

    def maybe_save(self, step: int, state, force: bool = False) -> bool:
        if not force and (self.every <= 0 or step % self.every):
            return False
        if self._pending is not None:
            self._pending.join()
        self._pending = save(self.dir, step, state, blocking=False)
        self._gc(step)
        return True

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def _gc(self, now_step: int) -> None:
        if not os.path.isdir(self.dir):
            return
        steps = sorted(
            int(n.split("_")[1])
            for n in os.listdir(self.dir)
            if n.startswith("step_") and not n.startswith(".tmp")
        )
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"), ignore_errors=True)
