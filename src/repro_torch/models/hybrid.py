"""Zamba2-style hybrid: Mamba-2 backbone + a *shared* attention block,
plain PyTorch.

Counterpart of ``repro/models/hybrid.py``.  The layer pattern is
``attn_every``-periodic: every ``attn_every``-th layer position runs the
single shared attention+MLP block (one parameter set reused at every site,
as in Zamba/Zamba2); all other positions are Mamba-2 blocks.  With
n_layers=81 and attn_every=6 that is 13 shared-attention applications and
68 Mamba layers.  Each attention site keeps its own K/V cache; a sliding
window makes it a ring buffer.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core.sim.replay_torch import resolve_device
from . import mamba2
from . import transformer as tf
from .layers import (DTYPE, ParamSpec, embed, layer_views, map_tree,
                     remat_call, rms_norm, shard, take_layer)

__all__ = ["param_specs", "forward", "decode_step", "init_cache", "plan_layers"]


def plan_layers(cfg) -> tuple[int, int, list[str]]:
    """Returns (n_mamba, n_attn, pattern list of 'm'/'a')."""
    pattern = ["a" if (i + 1) % cfg.attn_every == 0 else "m"
               for i in range(cfg.n_layers)]
    return pattern.count("m"), pattern.count("a"), pattern


def _shared_attn_specs(cfg) -> dict:
    """One dense transformer layer's worth of params (unstacked: the L dim
    of 1 folded away), shared across all attention sites."""
    sp = tf._layer_specs(dataclasses.replace(cfg, n_layers=1))
    return map_tree(lambda s: ParamSpec(s.shape[1:], s.axes[1:], s.dtype,
                                        s.init), sp)


def param_specs(cfg) -> dict:
    n_mamba, n_attn, _ = plan_layers(cfg)
    d = cfg.d_model
    return {
        "embed": ParamSpec((cfg.vocab, d), ("vocab", "embed"), init="embed"),
        "mamba": mamba2.block_specs(cfg, n_mamba),
        "shared_attn": _shared_attn_specs(cfg),
        "final_norm": ParamSpec((d,), ("embed",), init="ones"),
        "lm_head": ParamSpec((d, cfg.vocab), ("embed", "vocab")),
    }


def _segments(cfg) -> list[tuple[int, int, bool]]:
    """[(mamba_start, mamba_end, attn_after)] covering the layer pattern."""
    _, _, pattern = plan_layers(cfg)
    segs = []
    m = 0
    run = 0
    for p in pattern:
        if p == "m":
            run += 1
        else:
            segs.append((m, m + run, True))
            m += run
            run = 0
    if run:
        segs.append((m, m + run, False))
    return segs


def _head(params, x):
    return rms_norm(x, params["final_norm"]) @ params["lm_head"]


def forward(params, tokens, cfg, prefix_embeds=None, remat: bool = True,
            last_only: bool = False):
    """Teacher-forced forward -> logits (B, S, vocab).  ``prefix_embeds``
    is accepted and ignored, as in the reference; ``remat`` recomputes each
    Mamba layer and each shared-attention site in the backward."""
    x = embed(params, tokens)
    B, S = x.shape[0], x.shape[1]
    x = shard(x, "batch", "seq_res", "embed")
    positions = torch.arange(S, device=x.device).expand(B, S)
    mamba_body = lambda x, lw: mamba2.block_forward(x, lw, cfg)[0]
    attn_body = lambda x: tf._layer_body(x, params["shared_attn"], cfg,
                                         positions)
    n_mamba, _, _ = plan_layers(cfg)
    mws = layer_views(params["mamba"], n_mamba)
    for start, end, attn_after in _segments(cfg):
        for li in range(start, end):
            x = remat_call(mamba_body, x, mws[li], remat=remat)
        if attn_after:
            x = remat_call(attn_body, x, remat=remat)
    if last_only:
        x = x[:, -1:]
    return shard(_head(params, x), "batch", "seq", "vocab")


def init_cache(cfg, batch: int, max_len: int, device=None) -> dict:
    """SSM states, conv caches and one K/V cache per attention site on
    ``device`` (``None``: the card, ``RuntimeError`` without one)."""
    device = resolve_device(device)
    n_mamba, n_attn, _ = plan_layers(cfg)
    W = tf.cache_window(cfg, max_len)
    kv = (n_attn, batch, W, cfg.n_kv_heads, cfg.head_dim)
    return {
        "ssm": mamba2.init_state(cfg, batch, n_mamba, device=device),
        "k": torch.zeros(kv, dtype=DTYPE, device=device),
        "v": torch.zeros(kv, dtype=DTYPE, device=device),
        "pos": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def decode_step(params, cache, tokens, cfg):
    """One token: every Mamba layer's recurrent update and, at each
    attention site, the shared layer over that site's own K/V slice.  The
    caller's cache is left as it was."""
    x = embed(params, tokens)
    pos = cache["pos"]
    ssm, conv = cache["ssm"]["ssm"], cache["ssm"]["conv"]
    new_ssm, new_conv = [], []
    k_all = cache["k"].clone()
    v_all = cache["v"].clone()
    ai = 0
    for start, end, attn_after in _segments(cfg):
        for li in range(start, end):
            x, (s_new, c_new) = mamba2.block_decode(
                x, take_layer(params["mamba"], li), cfg, ssm[li], conv[li])
            new_ssm.append(s_new)
            new_conv.append(c_new)
        if attn_after:
            x, _, _ = tf._decode_layer(x, params["shared_attn"], k_all[ai],
                                       v_all[ai], pos, cfg)
            ai += 1
    new_cache = {
        "ssm": {"ssm": torch.stack(new_ssm), "conv": torch.stack(new_conv)},
        "k": k_all,
        "v": v_all,
        "pos": pos + 1,
    }
    return shard(_head(params, x), "batch", "seq", "vocab"), new_cache
