"""Dense decoder-only transformer (GQA + RoPE), plain PyTorch.

Counterpart of ``repro/models/transformer.py`` for serving: the parameter
specs, prefill (the prompt through the model, building the KV cache) and the
dense decode step over a full cache or a sliding-window ring buffer.  Covers
qwen2.5-3b, starcoder2-3b, qwen1.5-110b, llama3-405b and the Mistral backbone
of llava-next: RMSNorm/LayerNorm, SwiGLU/GELU FFN, QKV bias, sliding-window
attention, tied embeddings.

The layer stack is a Python loop over the stacked ``layers`` parameters.
The training forward (``forward``, with its remat groups) is not ported yet
(ROADMAP A15).
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from .layers import (
    DTYPE,
    ParamSpec,
    attention,
    decode_attention,
    layer_norm,
    mlp,
    rms_norm,
    rope,
)

__all__ = [
    "param_specs",
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
    def pick(tree):
        if isinstance(tree, dict):
            return {k: pick(v) for k, v in tree.items()}
        return tree[li]
    return pick(params["layers"])


def _norm(x, w, cfg, gamma_key, beta_key, lw=None):
    src = lw if lw is not None else w
    if cfg.norm_kind == "ln":
        return layer_norm(x, src[gamma_key], src[beta_key])
    return rms_norm(x, src[gamma_key])


def _qkv(x, lw, cfg, positions):
    B, S, d = x.shape
    dh = cfg.head_dim
    q = x @ lw["wq"]
    k = x @ lw["wk"]
    v = x @ lw["wv"]
    if cfg.qkv_bias:
        q, k, v = q + lw["bq"], k + lw["bk"], v + lw["bv"]
    q = q.reshape(B, S, cfg.n_heads, dh)
    k = k.reshape(B, S, cfg.n_kv_heads, dh)
    v = v.reshape(B, S, cfg.n_kv_heads, dh)
    if cfg.use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def _embed(params, tokens):
    return params["embed"].to(DTYPE)[tokens.long()]


def _head(params, x, cfg):
    x = _norm(x, params, cfg, "final_norm", "final_norm_b")
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return x @ head


def _ffn(x, lw, cfg):
    h = _norm(x, None, cfg, "mlp_norm", "mlp_norm_b", lw)
    return x + mlp(h, lw["mlp"], cfg.mlp_kind)


# ---------------------------------------------------------------------------
# Decode path (full cache or sliding-window ring buffer)
# ---------------------------------------------------------------------------

def cache_window(cfg, max_len: int) -> int:
    """Physical cache length: the sliding window if one exists (ring), else
    the full context."""
    if cfg.sliding_window is not None:
        return min(cfg.sliding_window, max_len)
    return max_len


def init_cache(cfg, batch: int, max_len: int, device="cpu") -> dict:
    W = cache_window(cfg, max_len)
    kv_shape = (cfg.n_layers, batch, W, cfg.n_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(kv_shape, dtype=DTYPE, device=device),
        "v": torch.zeros(kv_shape, dtype=DTYPE, device=device),
        "pos": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def decode_step(params: dict, cache: dict, tokens: torch.Tensor, cfg):
    """One autoregressive step. tokens: (B, 1) -> (logits (B,1,V), cache).

    The returned cache holds new K/V tensors; the caller's cache is left as
    it was.  As in the reference, the batch shares one position,
    ``cache["pos"][0]``.
    """
    x = _embed(params, tokens)
    B = x.shape[0]
    pos = cache["pos"]
    k_all = cache["k"].clone()
    v_all = cache["v"].clone()
    W = k_all.shape[2]
    pos0 = int(pos[0])
    slot = pos0 % W
    cache_len = min(pos0 + 1, W)
    positions = pos[:, None].expand(B, 1)
    for li in range(cfg.n_layers):
        lw = layer_params(params, li)
        h = _norm(x, None, cfg, "attn_norm", "attn_norm_b", lw)
        q, k, v = _qkv(h, lw, cfg, positions)
        k_all[li, :, slot] = k[:, 0]
        v_all[li, :, slot] = v[:, 0]
        o = decode_attention(q, k_all[li], v_all[li], cache_len)
        x = x + o.reshape(B, 1, -1) @ lw["wo"]
        x = _ffn(x, lw, cfg)
    logits = _head(params, x, cfg)
    return logits, {"k": k_all, "v": v_all, "pos": pos + 1}


def prefill(params: dict, tokens: torch.Tensor, cfg, max_len: int | None = None):
    """Run the prompt through the model, building the KV cache.

    Returns (last-token logits (B,1,V), cache), the cache in the ring layout
    of :func:`decode_step` (slot = position % W).
    """
    B, S = tokens.shape
    max_len = max_len or S
    W = cache_window(cfg, max_len)
    x = _embed(params, tokens)
    positions = torch.arange(S, device=x.device).expand(B, S)
    ks, vs = [], []
    for li in range(cfg.n_layers):
        lw = layer_params(params, li)
        h = _norm(x, None, cfg, "attn_norm", "attn_norm_b", lw)
        q, k, v = _qkv(h, lw, cfg, positions)
        o = attention(
            q, k, v, causal=cfg.causal, sliding_window=cfg.sliding_window,
            block_kv=cfg.attn_block_kv,
        )
        x = x + o.reshape(B, S, -1) @ lw["wo"]
        x = _ffn(x, lw, cfg)
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
