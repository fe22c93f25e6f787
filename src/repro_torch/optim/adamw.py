"""AdamW in plain PyTorch.

Counterpart of ``repro/optim/adamw.py``: the same update, in float32
whatever the parameter's dtype, with moments in ``moment_dtype`` (bfloat16
for the largest configs).  Leaves are visited in the reference's sorted-key
order, so the global gradient norm sums its per-leaf terms in the same
order.

``adamw_update`` updates in place, as PyTorch's optimisers do, and so stands
in for the reference's donated ``jit``: it writes each new leaf into the
caller's ``params`` and ``opt_state`` trees as soon as it is computed and
drops the gradient it used, so at most one leaf's old and new copies and
float32 temporaries exist at a time.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from ..models.layers import map_tree
from ..tree import get_leaf, leaf_paths, leaves, set_leaf
from ._ieee import sqrt

__all__ = ["AdamWConfig", "init_opt_state", "adamw_update"]


@dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: Any = torch.float32


def init_opt_state(params, cfg: AdamWConfig) -> dict:
    zeros = lambda p: torch.zeros(p.shape, dtype=cfg.moment_dtype,
                                  device=p.device)
    return {
        "m": map_tree(zeros, params),
        "v": map_tree(zeros, params),
        "count": torch.zeros((), dtype=torch.int32,
                             device=leaves(params)[0].device),
    }


def _global_norm(tree) -> torch.Tensor:
    sq = sum(torch.sum(torch.square(x.float())) for x in leaves(tree))
    return sqrt(sq)


def _f32_copy(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32, copy=True)


def _upd(p, g, m, v, lr, scale, b1c, b2c, cfg: AdamWConfig):
    # The reference's expressions, one rounding an operation; the in-place
    # forms only reuse temporaries (a leaf of 811 M entries is 3.2 GB in
    # float32) and round exactly as the out-of-place ones.
    g = _f32_copy(g).mul_(scale)
    m32 = m.float() * cfg.b1
    m32.add_(g * (1 - cfg.b1))
    v32 = v.float() * cfg.b2
    v32.add_(g.mul_(g).mul_(1 - cfg.b2))
    del g
    step = m32 / b1c
    step.div_(sqrt(v32 / b2c).add_(cfg.eps))
    if cfg.weight_decay:
        step.add_(_f32_copy(p).mul_(cfg.weight_decay))
    new_p = _f32_copy(p).sub_(step.mul_(lr)).to(p.dtype)
    return new_p, m32.to(cfg.moment_dtype), v32.to(cfg.moment_dtype)


def adamw_update(params, grads, opt_state, lr, cfg: AdamWConfig):
    """One AdamW step; returns (new_params, new_opt_state, metrics).

    ``params`` and ``opt_state``'s moment trees are updated in place, leaf
    by leaf, and returned; ``grads``' leaves are emptied as they are used."""
    count = opt_state["count"] + 1
    gnorm = _global_norm(grads)
    # ``number / tensor`` would multiply by the reciprocal: divide tensors
    scale = (torch.clamp(torch.full_like(gnorm, cfg.grad_clip)
                         / (gnorm + 1e-9), max=1.0)
             if cfg.grad_clip else 1.0)

    b1c = 1.0 - cfg.b1 ** count.to(torch.float32)
    b2c = 1.0 - cfg.b2 ** count.to(torch.float32)
    lr = torch.as_tensor(lr, dtype=torch.float32, device=count.device)

    # paths only: a list of the old leaves would keep them all alive
    for path in [path for path, _ in leaf_paths(params)]:
        g = get_leaf(grads, path)
        set_leaf(grads, path, None)
        p, m, v = _upd(get_leaf(params, path), g,
                       get_leaf(opt_state["m"], path),
                       get_leaf(opt_state["v"], path),
                       lr, scale, b1c, b2c, cfg)
        del g
        set_leaf(params, path, p)
        set_leaf(opt_state["m"], path, m)
        set_leaf(opt_state["v"], path, v)
        del p, m, v
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, {"m": opt_state["m"], "v": opt_state["v"],
                    "count": count}, metrics
