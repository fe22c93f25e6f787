"""Gradient compression: int8 quantization with error feedback.

Counterpart of ``repro/optim/grad_compress.py``: symmetric per-tensor int8
(``quantize`` / ``dequantize``) and the error-feedback codec over a tree of
gradients (``ef_compress_grads``; Seide et al.'s 1-bit SGD discipline: the
quantization residual is re-injected at the next step).  ``torch.round``
rounds half to even, as the reference's rounding does.

``make_crosspod_psum`` reduces the int8 payload over a mesh's ``pod`` axis
(the DCN-crossing link of a multi-pod mesh, the term worth compressing):
the reference's ``shard_map`` body, with its ``pmax`` / ``psum`` as
all-reduces over the mesh's ``pod`` process group.
"""
from __future__ import annotations

import torch

from ..models.layers import map_tree
from ..tree import get_leaf, leaf_paths, set_leaf

__all__ = ["quantize", "dequantize", "ef_compress_grads", "make_crosspod_psum"]


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


def make_crosspod_psum(mesh):
    """Returns psum_int8(q_tree, scale_tree) -> mean-gradient tree, reducing
    over the ``pod`` axis of ``mesh`` (a named ``DeviceMesh``); ``None``
    without a pod axis.  The trees hold this rank's local tensors (the
    reference's ``shard_map`` body sees its shard the same way), and every
    rank of a pod group calls it."""
    from ..distributed.sharding import axis_names, axis_size

    if "pod" not in axis_names(mesh):
        return None
    import torch.distributed as dist

    n_pods = axis_size(mesh, "pod")
    group = mesh.get_group("pod")

    def psum_one(q, s):
        # scales differ per pod: agree on the max scale, requantize the
        # local payload to it, then integer-sum (carried as int32; the wire
        # format of a production int8 ring would be the int8 q)
        s_shared = s.detach().clone()
        dist.all_reduce(s_shared, op=dist.ReduceOp.MAX, group=group)
        qr = torch.round(q.float() * (s / s_shared)).to(torch.int32)
        dist.all_reduce(qr, op=dist.ReduceOp.SUM, group=group)
        # a tensor divisor: a Python number may be applied as a reciprocal
        return qr.float() * (s_shared / torch.full_like(s_shared, n_pods))

    def crosspod(q_tree, s_tree):
        if not isinstance(q_tree, dict):
            return psum_one(q_tree, s_tree)
        return {k: crosspod(q_tree[k], s_tree[k]) for k in sorted(q_tree)}

    return crosspod
