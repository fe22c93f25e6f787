"""Gradient compression: int8 quantization with error feedback.

Counterpart of ``repro/optim/grad_compress.py``: symmetric per-tensor int8
(``quantize`` / ``dequantize``) and the error-feedback codec over a tree of
gradients (``ef_compress_grads``; Seide et al.'s 1-bit SGD discipline: the
quantization residual is re-injected at the next step).  ``torch.round``
rounds half to even, as the reference's rounding does.

Not ported yet: ``make_crosspod_psum``, the reduction of the int8 payload
over a mesh's ``pod`` axis, which needs the port's distribution layer
(``ROADMAP.md`` A16).
"""
from __future__ import annotations

import torch

from ..models.layers import map_tree
from ..tree import get_leaf, leaf_paths, set_leaf

__all__ = ["quantize", "dequantize", "ef_compress_grads"]


def quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8. Returns (q, scale)."""
    xf = x.float()
    scale = torch.clamp(torch.max(torch.abs(xf)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def ef_compress_grads(grads, err):
    """Quantize each gradient leaf with error feedback.

    Returns (q_tree, scale_tree, new_err_tree). The caller reduces q across
    replicas and dequantizes; new_err holds what quantization dropped.
    """
    def one(g, e):
        y = g.float() + e.float()
        q, s = quantize(y)
        back = dequantize(q, s)
        return q, s, (y - back).to(e.dtype)

    qs, ss, es = (map_tree(lambda a: a, grads) for _ in range(3))
    for path, g in leaf_paths(grads):
        for tree, val in zip((qs, ss, es), one(g, get_leaf(err, path))):
            set_leaf(tree, path, val)
    return qs, ss, es
