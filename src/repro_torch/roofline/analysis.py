"""Parameter counts and model FLOPs of a configuration.

Counterpart of the three helpers of ``repro/roofline/analysis.py`` that do
not depend on XLA: ``model_flops``, ``count_params`` and ``active_params``.
``count_params`` walks a ParamSpec tree (nested dicts whose leaves have
``shape`` and ``axes``) in place of the reference's tree library.
The rest of that module reads compiled HLO and has no counterpart in the
port: its rooflines are measured kernel times beside the card's bounds
(``benchmarks/kernels_bench_torch.py``).
"""
from __future__ import annotations

import math

__all__ = ["model_flops", "count_params", "active_params"]


def model_flops(cfg, shape, n_params: int, n_active: int) -> float:
    """MODEL_FLOPS: 6*N*D for training, 2*N*D for prefill, 2*N*B for decode
    (N = active params for MoE)."""
    D = shape.global_batch * shape.seq_len
    if shape.kind == "train":
        return 6.0 * n_active * D
    if shape.kind == "prefill":
        return 2.0 * n_active * D
    return 2.0 * n_active * shape.global_batch  # decode: one token per seq


def _spec_leaves(specs):
    if hasattr(specs, "shape") and hasattr(specs, "axes"):
        return [specs]
    if isinstance(specs, dict):
        return [s for v in specs.values() for s in _spec_leaves(v)]
    if isinstance(specs, (list, tuple)):
        return [s for v in specs for s in _spec_leaves(v)]
    return []


def count_params(specs) -> int:
    return int(sum(math.prod(s.shape) for s in _spec_leaves(specs)))


def active_params(cfg, specs) -> int:
    """Active-per-token parameter count (MoE: top_k + shared experts only)."""
    total = count_params(specs)
    if cfg.family != "moe":
        return total
    # subtract the inactive routed experts
    per_expert = 3 * cfg.d_model * cfg.d_expert * cfg.n_layers
    inactive = (cfg.n_experts - cfg.top_k) * per_expert
    return int(total - inactive)
