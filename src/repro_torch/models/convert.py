"""Carry a parameter tree over from the reference, bit for bit.

The reference's parameters reach the port as a nested dict of numpy arrays
(``np.asarray`` of each leaf).  Its bfloat16 leaves come out of numpy with
the ``ml_dtypes`` bfloat16 dtype, which :func:`torch.from_numpy` does not
take: their 16-bit patterns are carried as ``uint16`` and reinterpreted as
``torch.bfloat16``.  The dtype is recognised by its name, so nothing here
imports ``ml_dtypes``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.sim.replay_torch import resolve_device

__all__ = ["params_from_numpy", "tensor_from_numpy"]


def tensor_from_numpy(arr, device="cpu") -> torch.Tensor:
    """One array -> a tensor with the same bits on ``device``.

    Read-only arrays are copied first (``torch.from_numpy`` shares memory
    and warns on them)."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(arr).view(np.uint16).copy()
        return torch.from_numpy(bits).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def params_from_numpy(tree, device=None):
    """A nested dict (or list/tuple) of arrays -> the same nesting of
    tensors on ``device`` (``None``: the card, ``RuntimeError`` without one;
    pass ``device="cpu"`` for the host)."""
    return _to_tensors(tree, resolve_device(device))


def _to_tensors(tree, device):
    if isinstance(tree, dict):
        return {k: _to_tensors(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_tensors(v, device) for v in tree)
    return tensor_from_numpy(tree, device)
