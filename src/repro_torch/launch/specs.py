"""Abstract inputs + sharding assignments for every dry-run cell.

Counterpart of ``repro/launch/specs.py``.  ``make_cell(arch, shape, mesh)``
returns everything :mod:`.dryrun` needs: the step function, its inputs as
``meta`` tensors (shapes and dtypes, nothing allocated) and their
:class:`~repro_torch.distributed.sharding.NamedSharding` trees -- for the
train, prefill and decode kinds.  ``mesh`` is a named ``DeviceMesh`` (or,
for :func:`default_microbatches`, anything with named axis sizes).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from ..configs import SHAPES, get_config, shape_applicable, shape_config
from ..distributed.sharding import (
    NamedSharding,
    act_rules,
    axis_names,
    axis_size,
    batch_shardings,
    cache_shardings,
    state_shardings,
)
from ..models.layers import abstract_params, mesh_context
from ..optim.adamw import AdamWConfig, init_opt_state
from ..train.train_step import TrainHParams, make_train_step
from ..zoo import get_api

__all__ = ["Cell", "make_cell", "batch_specs", "default_microbatches",
           "abstract_cache"]

DTYPE = torch.bfloat16


def _abstract(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_specs(cfg, shape) -> dict[str, torch.Tensor]:
    """Abstract model inputs for one (arch, shape) cell."""
    B, S = shape.global_batch, shape.seq_len
    out: dict[str, torch.Tensor] = {}
    if shape.kind == "decode":
        out["tokens"] = _abstract((B, 1), torch.int32)
        return out
    s_text = S
    if cfg.family == "vlm":
        s_text = S - cfg.n_patches
        out["patches"] = _abstract((B, cfg.n_patches, cfg.vision_dim), DTYPE)
    if cfg.family == "encdec":
        out["frames"] = _abstract((B, cfg.n_frames, cfg.d_model), DTYPE)
    out["tokens"] = _abstract((B, s_text), torch.int32)
    if shape.kind == "train":
        out["targets"] = _abstract((B, S), torch.int32)
        out["loss_mask"] = _abstract((B, S), torch.float32)
    return out


def default_microbatches(cfg, shape, mesh, policy: str = "baseline") -> int:
    """Pick microbatch count so the per-device microbatch is a few
    sequences (1 for the >=8k-wide models) -- the activation-memory knob."""
    dp = axis_size(mesh, "data") * (
        axis_size(mesh, "pod") if "pod" in axis_names(mesh) else 1)
    if policy == "dp2d":
        dp *= axis_size(mesh, "model")
    b_loc = max(shape.global_batch // dp, 1)
    target = 1 if cfg.d_model >= 8192 else 4
    mb = max(b_loc // target, 1)
    while shape.global_batch % mb:
        mb -= 1
    return max(mb, 1)


def abstract_cache(api, cfg, shape):
    """The decode cache of a cell as ``meta`` tensors."""
    return api.init_cache(cfg, shape.global_batch, shape.seq_len,
                          device="meta")


@dataclass
class Cell:
    arch: str
    shape_name: str
    cfg: Any
    fn: Callable              # the step function
    kwargs: dict              # abstract inputs, in fn's argument order
    in_shardings: Any
    out_shardings: Any
    donate: tuple = ()
    skip_reason: str = ""

    @property
    def skipped(self) -> bool:
        return bool(self.skip_reason)


def _prefill(cfg, params, batch):
    """The prefill cell's forward: logits of the final position only
    (full-sequence logits are never materialized)."""
    from ..models import hybrid, moe, rwkv6, transformer, vlm, whisper

    mod = {"dense": transformer, "moe": moe, "vlm": vlm, "hybrid": hybrid,
           "ssm": rwkv6, "encdec": whisper}[cfg.family]
    if cfg.family == "vlm":
        out = mod.forward(params, batch["tokens"], cfg, remat=False,
                          last_only=True, patches=batch.get("patches"))
    elif cfg.family == "encdec":
        out = mod.forward(params, batch["tokens"], cfg,
                          frames=batch["frames"], remat=False,
                          last_only=True)
    else:
        out = mod.forward(params, batch["tokens"], cfg, remat=False,
                          last_only=True)
    return out[0] if isinstance(out, tuple) else out


def make_cell(arch: str, shape_name: str, mesh, hp: TrainHParams | None = None,
              cfg_override=None, policy: str = "baseline",
              shape=None) -> Cell:
    """One cell; ``shape`` (a :class:`~repro_torch.configs.Shape`) stands in
    for ``SHAPES[shape_name]`` where a caller builds a cell of its own."""
    shape = shape if shape is not None else SHAPES[shape_name]
    cfg0 = cfg_override if cfg_override is not None else get_config(arch)
    ok, why = shape_applicable(cfg0, shape)
    if not ok:
        return Cell(arch, shape_name, cfg0, None, {}, None, None, skip_reason=why)
    cfg = shape_config(cfg0, shape)
    api = get_api(cfg)
    specs = api.param_specs(cfg)
    params_abs = abstract_params(specs)
    p_shard = state_shardings(specs, mesh, policy=policy)
    rules = act_rules(mesh, policy=policy)
    b_abs = batch_specs(cfg, shape)
    b_shard = batch_shardings(b_abs, mesh, policy=policy)
    mdtype = torch.bfloat16 if cfg.moment_dtype == "bfloat16" else torch.float32

    if shape.kind == "train":
        hp = hp or TrainHParams(microbatches=default_microbatches(cfg, shape, mesh, policy))
        step = make_train_step(api, cfg, hp, moment_dtype=mdtype)

        def fn(state, batch):
            with mesh_context(mesh, rules):
                return step(state, batch)

        opt_abs = init_opt_state(params_abs, AdamWConfig(moment_dtype=mdtype))
        opt_shard = {"m": p_shard, "v": p_shard,
                     "count": NamedSharding(mesh, ())}
        state_abs = {"params": params_abs, "opt": opt_abs}
        state_shard = {"params": p_shard, "opt": opt_shard}
        return Cell(
            arch, shape_name, cfg, fn,
            {"state": state_abs, "batch": b_abs},
            (state_shard, b_shard),
            (state_shard, None),
            donate=(0,),
        )

    if shape.kind == "prefill":
        def fn_last(params, batch):
            with torch.no_grad(), mesh_context(mesh, rules):
                return _prefill(cfg, params, batch)

        return Cell(
            arch, shape_name, cfg, fn_last,
            {"params": params_abs, "batch": b_abs},
            (p_shard, b_shard),
            None,
        )

    # decode
    cache_abs = abstract_cache(api, cfg, shape)
    c_shard = cache_shardings(cache_abs, mesh, batch_dim=1)

    def fn(params, cache, tokens):
        with torch.no_grad(), mesh_context(mesh, rules):
            return api.decode(params, cache, tokens, cfg)

    tok_shard = batch_shardings({"t": b_abs["tokens"]}, mesh)["t"]
    return Cell(
        arch, shape_name, cfg, fn,
        {"params": params_abs, "cache": cache_abs, "tokens": b_abs["tokens"]},
        (p_shard, c_shard, tok_shard),
        (None, c_shard),
        donate=(1,),
    )
