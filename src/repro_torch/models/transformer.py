"""Dense decoder-only transformer (GQA + RoPE), plain PyTorch.

Counterpart of ``repro/models/transformer.py``: the parameter specs, the
inference ``forward`` (logits of every position), prefill (the prompt
through the model, building the KV cache) and the dense decode step over a
full cache or a sliding-window ring buffer.  Covers qwen2.5-3b,
starcoder2-3b, qwen1.5-110b, llama3-405b and the Mistral backbone of
llava-next: RMSNorm/LayerNorm, SwiGLU/GELU FFN, QKV bias, sliding-window
attention, tied embeddings.

The layer stack is a Python loop over the stacked ``layers`` parameters.
``forward(remat=True)`` recomputes each layer in the backward, as the
reference's checkpointing of its scanned layer body; with
``cfg.remat_groups = G > 1`` the layers also run in G checkpointed groups
(two-level remat: only the G group boundaries stay alive, and a group's
layer boundaries while its backward runs).
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from ..core.sim.replay_torch import resolve_device
from .layers import (
    DTYPE,
    ParamSpec,
    attention,
    decode_attention,
    embed,
    layer_norm,
    layer_views,
    merge_dims,
    mlp,
    reduce_proj,
    remat_call,
    rms_norm,
    rope,
    shard,
    split_dim,
    take_layer,
    write_slot,
)

__all__ = [
    "param_specs",
    "forward",
    "prefill",
    "decode_step",
    "init_cache",
    "cache_window",
    "layer_params",
]


def _layer_specs(cfg) -> dict:
    d, hq, hkv, dh, ff = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff
    L = cfg.n_layers
    sp: dict[str, Any] = {
        "attn_norm": ParamSpec((L, d), ("layers", "embed"), init="ones"),
        "mlp_norm": ParamSpec((L, d), ("layers", "embed"), init="ones"),
        "wq": ParamSpec((L, d, hq * dh), ("layers", "embed", "heads_flat")),
        "wk": ParamSpec((L, d, hkv * dh), ("layers", "embed", None)),
        "wv": ParamSpec((L, d, hkv * dh), ("layers", "embed", None)),
        "wo": ParamSpec((L, hq * dh, d), ("layers", "heads_flat", "embed")),
    }
    if cfg.qkv_bias:
        sp["bq"] = ParamSpec((L, hq * dh), ("layers", "heads_flat"), init="zeros")
        sp["bk"] = ParamSpec((L, hkv * dh), ("layers", None), init="zeros")
        sp["bv"] = ParamSpec((L, hkv * dh), ("layers", None), init="zeros")
    if cfg.mlp_kind == "swiglu":
        sp["mlp"] = {
            "wi_gate": ParamSpec((L, d, ff), ("layers", "embed", "mlp")),
            "wi_up": ParamSpec((L, d, ff), ("layers", "embed", "mlp")),
            "wo": ParamSpec((L, ff, d), ("layers", "mlp", "embed")),
        }
    else:
        sp["mlp"] = {
            "wi": ParamSpec((L, d, ff), ("layers", "embed", "mlp")),
            "wo": ParamSpec((L, ff, d), ("layers", "mlp", "embed")),
        }
    if cfg.norm_kind == "ln":
        sp["attn_norm_b"] = ParamSpec((L, d), ("layers", "embed"), init="zeros")
        sp["mlp_norm_b"] = ParamSpec((L, d), ("layers", "embed"), init="zeros")
    return sp


def param_specs(cfg) -> dict:
    d = cfg.d_model
    sp = {
        "embed": ParamSpec((cfg.vocab, d), ("vocab", "embed"), init="embed"),
        "layers": _layer_specs(cfg),
        "final_norm": ParamSpec((d,), ("embed",), init="ones"),
    }
    if cfg.norm_kind == "ln":
        sp["final_norm_b"] = ParamSpec((d,), ("embed",), init="zeros")
    if not cfg.tie_embeddings:
        sp["lm_head"] = ParamSpec((d, cfg.vocab), ("embed", "vocab"))
    return sp


def layer_params(params: dict, li: int) -> dict:
    """Views of layer ``li``'s weights in the stacked ``params["layers"]``."""
    return take_layer(params["layers"], li)


def _norm(x, w, cfg, gamma_key, beta_key, lw=None):
    src = lw if lw is not None else w
    if cfg.norm_kind == "ln":
        return layer_norm(x, src[gamma_key], src[beta_key])
    return rms_norm(x, src[gamma_key])


def _qkv(x, lw, cfg, positions):
    dh = cfg.head_dim
    q = x @ lw["wq"]
    k = x @ lw["wk"]
    v = x @ lw["wv"]
    if cfg.qkv_bias:
        q, k, v = q + lw["bq"], k + lw["bk"], v + lw["bv"]
    q = split_dim(q, 2, (cfg.n_heads, dh))
    k = split_dim(k, 2, (cfg.n_kv_heads, dh))
    v = split_dim(v, 2, (cfg.n_kv_heads, dh))
    q = shard(q, "batch", "seq", "heads", None)
    if cfg.use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def _head(params, x, cfg):
    x = _norm(x, params, cfg, "final_norm", "final_norm_b")
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return x @ head


def _ffn(x, lw, cfg):
    h = _norm(x, None, cfg, "mlp_norm", "mlp_norm_b", lw)
    return x + mlp(h, lw["mlp"], cfg.mlp_kind)


def _attn_block(x, lw, cfg, positions):
    """Pre-norm self-attention with its residual, before the FFN; returns
    ``(x, k, v)``."""
    h = _norm(x, None, cfg, "attn_norm", "attn_norm_b", lw)
    q, k, v = _qkv(h, lw, cfg, positions)
    o = attention(
        q, k, v, causal=cfg.causal, sliding_window=cfg.sliding_window,
        block_kv=cfg.attn_block_kv,
    )
    # the output projection contracts the model-sharded heads: its partial
    # sums are reduced here, or they would flow into the FFN (whose matmuls
    # DTensor then runs on whole weights)
    o = reduce_proj(merge_dims(o, 2), lw["wo"],
                    "batch", "seq_res", "embed")
    return x + o, k, v


def _layer_body(x, lw, cfg, positions):
    x, _, _ = _attn_block(x, lw, cfg, positions)
    return shard(_ffn(x, lw, cfg), "batch", "seq_res", "embed")


def forward(params: dict, tokens: torch.Tensor, cfg,
            prefix_embeds: torch.Tensor | None = None, remat: bool = True,
            last_only: bool = False) -> torch.Tensor:
    """Teacher-forced forward -> logits (B, S, vocab).

    ``prefix_embeds`` (B, S_pre, d) go in front of the token embeddings
    (the VLM's projected patches); ``last_only`` applies the head to the
    final position only.  ``remat`` recomputes each layer in the backward
    (and ``cfg.remat_groups`` adds the group level, as in the reference)."""
    x = embed(params, tokens)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(DTYPE), x], dim=1)
    B, S, _ = x.shape
    x = shard(x, "batch", "seq_res", "embed")
    positions = torch.arange(S, device=x.device).expand(B, S)

    lws = layer_views(params["layers"], cfg.n_layers)

    def layers(x, start, end):
        for li in range(start, end):
            x = remat_call(_layer_body, x, lws[li], cfg, positions,
                           remat=remat)
        return x

    G = cfg.remat_groups
    if G > 1 and cfg.n_layers % G == 0 and not cfg.unroll_layers:
        # 2-level ("sqrt") remat: only the G group-boundary activations are
        # saved; each group's layers are recomputed during its backward.
        per = cfg.n_layers // G
        for g in range(G):
            x = remat_call(layers, x, g * per, (g + 1) * per)
    else:
        x = layers(x, 0, cfg.n_layers)
    if last_only:
        x = x[:, -1:]
    return shard(_head(params, x, cfg), "batch", "seq", "vocab")


# ---------------------------------------------------------------------------
# Decode path (full cache or sliding-window ring buffer)
# ---------------------------------------------------------------------------

def cache_window(cfg, max_len: int) -> int:
    """Physical cache length: the sliding window if one exists (ring), else
    the full context."""
    if cfg.sliding_window is not None:
        return min(cfg.sliding_window, max_len)
    return max_len


def init_cache(cfg, batch: int, max_len: int, device=None) -> dict:
    """Zeroed K/V cache and positions on ``device`` (``None``: the card,
    ``RuntimeError`` without one; pass ``device="cpu"`` for the host)."""
    device = resolve_device(device)
    W = cache_window(cfg, max_len)
    kv_shape = (cfg.n_layers, batch, W, cfg.n_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(kv_shape, dtype=DTYPE, device=device),
        "v": torch.zeros(kv_shape, dtype=DTYPE, device=device),
        "pos": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def _decode_attn_block(x, lw, k_cache, v_cache, pos, cfg):
    """Self-attention of one decode token with its residual, over one
    layer's cache (B, W, Hkv, D).

    Writes the token's K/V into slot ``pos[0] % W`` of ``k_cache`` and
    ``v_cache`` in place (callers pass their own copy).  The slot and the
    valid length stay on the device: no host sync."""
    B = x.shape[0]
    h = _norm(x, None, cfg, "attn_norm", "attn_norm_b", lw)
    q, k, v = _qkv(h, lw, cfg, pos[:, None].expand(B, 1))
    W = k_cache.shape[1]
    slot = (pos[:1] % W).long()
    write_slot(k_cache, slot, k)
    write_slot(v_cache, slot, v)
    cache_len = torch.clamp(pos[:1] + 1, max=W)
    o = decode_attention(q, k_cache, v_cache, cache_len)
    return x + o.reshape(B, 1, -1) @ lw["wo"]


def _decode_layer(x, lw, k_cache, v_cache, pos, cfg):
    """One decode layer; writes the caches in place as
    :func:`_decode_attn_block` does and returns ``(x, k_cache, v_cache)``."""
    x = _decode_attn_block(x, lw, k_cache, v_cache, pos, cfg)
    return _ffn(x, lw, cfg), k_cache, v_cache


def decode_step(params: dict, cache: dict, tokens: torch.Tensor, cfg):
    """One autoregressive step. tokens: (B, 1) -> (logits (B,1,V), cache).

    The returned cache holds new K/V tensors; the caller's cache is left as
    it was.  As in the reference, the batch shares one position,
    ``cache["pos"][0]``.
    """
    x = shard(embed(params, tokens), "batch", "seq_res", "embed")
    pos = cache["pos"]
    k_all = cache["k"].clone()
    v_all = cache["v"].clone()
    for li in range(cfg.n_layers):
        x, _, _ = _decode_layer(x, layer_params(params, li), k_all[li],
                                v_all[li], pos, cfg)
    logits = _head(params, x, cfg)
    return (shard(logits, "batch", "seq", "vocab"),
            {"k": k_all, "v": v_all, "pos": pos + 1})


def prefill(params: dict, tokens: torch.Tensor, cfg, max_len: int | None = None):
    """Run the prompt through the model, building the KV cache.

    Returns (last-token logits (B,1,V), cache), the cache in the ring layout
    of :func:`decode_step` (slot = position % W).
    """
    B, S = tokens.shape
    max_len = max_len or S
    W = cache_window(cfg, max_len)
    x = shard(embed(params, tokens), "batch", "seq_res", "embed")
    positions = torch.arange(S, device=x.device).expand(B, S)
    ks, vs = [], []
    for li in range(cfg.n_layers):
        lw = layer_params(params, li)
        x, k, v = _attn_block(x, lw, cfg, positions)
        x = shard(_ffn(x, lw, cfg), "batch", "seq_res", "embed")
        # keep the last W positions in the (ring) cache, slot = pos % W
        k_keep = k[:, -W:]
        v_keep = v[:, -W:]
        if S >= W:
            # slot s must hold absolute position p with p % W == s; the last
            # W positions are [S-W, S), so index j -> slot (j + S) % W.
            ks.append(torch.roll(k_keep, S % W, dims=1))
            vs.append(torch.roll(v_keep, S % W, dims=1))
        else:
            pad = W - S
            ks.append(F.pad(k_keep, (0, 0, 0, 0, 0, pad)))
            vs.append(F.pad(v_keep, (0, 0, 0, 0, 0, pad)))
    logits = _head(params, x[:, -1:], cfg)
    cache = {
        "k": torch.stack(ks),
        "v": torch.stack(vs),
        "pos": torch.full((B,), S, dtype=torch.int32, device=x.device),
    }
    return logits, cache
