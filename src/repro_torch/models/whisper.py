"""Whisper-style encoder-decoder (audio backbone; conv frontend stubbed),
plain PyTorch.

Counterpart of ``repro/models/whisper.py``.  The modality frontend is a
stub: callers pass precomputed mel-frame embeddings (B, T_frames, d_model)
in place of the two strided conv1d layers.  Encoder: bidirectional
transformer with sinusoidal positions.  Decoder: causal self-attention
(learned positions) + cross-attention to the encoder output + GELU FFN
(the tanh approximation, the reference's GELU), all pre-LN.  The head is
tied to the vocabulary-padded embedding, so logits have
:func:`padded_vocab` columns.  ``remat`` recomputes each encoder and
decoder layer in the backward, as the reference does.
"""
from __future__ import annotations

import math

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
    reduce_proj,
    remat_call,
    shard,
    split_dim,
    take_layer,
    write_slot,
)

__all__ = ["param_specs", "forward", "encode", "decode_step", "init_cache",
           "precompute_cross_kv", "padded_vocab"]


def _mha_specs(L, d, prefix=""):
    return {
        prefix + "wq": ParamSpec((L, d, d), ("layers", "embed", "heads_flat")),
        prefix + "wk": ParamSpec((L, d, d), ("layers", "embed", "heads_flat")),
        prefix + "wv": ParamSpec((L, d, d), ("layers", "embed", "heads_flat")),
        prefix + "wo": ParamSpec((L, d, d), ("layers", "heads_flat", "embed")),
        prefix + "bq": ParamSpec((L, d), ("layers", "heads_flat"), init="zeros"),
        prefix + "bv": ParamSpec((L, d), ("layers", "heads_flat"), init="zeros"),
        prefix + "bo": ParamSpec((L, d), ("layers", "embed"), init="zeros"),
    }


def _block_specs(L, d, ff, cross: bool):
    sp = {
        "ln1": ParamSpec((L, d), ("layers", "embed"), init="ones"),
        "ln1_b": ParamSpec((L, d), ("layers", "embed"), init="zeros"),
        "ln2": ParamSpec((L, d), ("layers", "embed"), init="ones"),
        "ln2_b": ParamSpec((L, d), ("layers", "embed"), init="zeros"),
        "mlp": {
            "wi": ParamSpec((L, d, ff), ("layers", "embed", "mlp")),
            "bi": ParamSpec((L, ff), ("layers", "mlp"), init="zeros"),
            "wo": ParamSpec((L, ff, d), ("layers", "mlp", "embed")),
            "bo": ParamSpec((L, d), ("layers", "embed"), init="zeros"),
        },
        **_mha_specs(L, d),
    }
    if cross:
        sp.update(_mha_specs(L, d, "x_"))
        sp["lnx"] = ParamSpec((L, d), ("layers", "embed"), init="ones")
        sp["lnx_b"] = ParamSpec((L, d), ("layers", "embed"), init="zeros")
    return sp


def padded_vocab(cfg) -> int:
    """The vocabulary padded to a multiple of 16, as in the reference
    (51 865 -> 51 872); the dead ids never appear as targets."""
    return -(-cfg.vocab // 16) * 16


def param_specs(cfg) -> dict:
    d, ff = cfg.d_model, cfg.d_ff
    L = cfg.n_layers               # encoder layers == decoder layers
    return {
        "embed": ParamSpec((padded_vocab(cfg), d), ("vocab", "embed"), init="embed"),
        "pos_dec": ParamSpec((cfg.max_positions, d), (None, "embed"), init="embed"),
        "enc": _block_specs(L, d, ff, cross=False),
        "dec": _block_specs(L, d, ff, cross=True),
        "ln_enc": ParamSpec((d,), ("embed",), init="ones"),
        "ln_enc_b": ParamSpec((d,), ("embed",), init="zeros"),
        "ln_dec": ParamSpec((d,), ("embed",), init="ones"),
        "ln_dec_b": ParamSpec((d,), ("embed",), init="zeros"),
    }


def _sinusoid(T: int, d: int, device=None) -> torch.Tensor:
    """(T, d) sinusoidal positions in bfloat16; the frequencies divide by
    ``d // 2 - 1``, as in the reference."""
    half = torch.arange(d // 2, dtype=torch.float32, device=device)
    inv = torch.exp(-math.log(10000.0) * half / (d // 2 - 1))
    ang = torch.arange(T, dtype=torch.float32, device=device)[:, None] \
        * inv[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=1).to(DTYPE)


def _mha(x, kv, lw, cfg, prefix="", causal=False):
    S, d = x.shape[1:]
    H = cfg.n_heads
    dh = d // H
    q = x @ lw[prefix + "wq"] + lw[prefix + "bq"]
    k = kv @ lw[prefix + "wk"]
    v = kv @ lw[prefix + "wv"] + lw[prefix + "bv"]
    Skv = kv.shape[1]
    q = split_dim(q, 2, (H, dh))
    k = split_dim(k, 2, (H, dh))
    v = split_dim(v, 2, (H, dh))
    if S == Skv:
        o = attention(q, k, v, causal=causal, block_kv=cfg.attn_block_kv)
    else:  # cross-attention, never causal
        o = _cross_attn(q, k, v)
    return reduce_proj(merge_dims(o, 2), lw[prefix + "wo"], "batch",
                       "seq_res", "embed") + lw[prefix + "bo"]


def _cross_attn(q, k, v):
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, k.float())
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


def _ffn(x, lw):
    h = x @ lw["mlp"]["wi"] + lw["mlp"]["bi"]
    h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    h = shard(h, "batch", "seq", "mlp")
    return reduce_proj(h, lw["mlp"]["wo"], "batch", "seq_res",
                       "embed") + lw["mlp"]["bo"]


def encode(params, frames, cfg, remat: bool = True):
    """frames: (B, T, d_model) precomputed frame embeddings (conv stub)."""
    x = frames.to(DTYPE) + _sinusoid(frames.shape[1], cfg.d_model,
                                     frames.device)[None]
    x = shard(x, "batch", "seq_res", "embed")

    def body(x, lw):
        h = layer_norm(x, lw["ln1"], lw["ln1_b"])
        x = x + _mha(h, h, lw, cfg, causal=False)
        h = layer_norm(x, lw["ln2"], lw["ln2_b"])
        return shard(x + _ffn(h, lw), "batch", "seq_res", "embed")

    for lw in layer_views(params["enc"], cfg.n_layers):
        x = remat_call(body, x, lw, remat=remat)
    return layer_norm(x, params["ln_enc"], params["ln_enc_b"])


def _head(params, x):
    x = layer_norm(x, params["ln_dec"], params["ln_dec_b"])
    return x @ params["embed"].T


def forward(params, tokens, cfg, frames=None, remat: bool = True,
            last_only: bool = False):
    """Teacher-forced decoder logits (B, S, padded_vocab). frames: (B, T, d)
    stub embeddings."""
    enc_out = encode(params, frames, cfg, remat)
    B, S = tokens.shape
    x = embed(params, tokens) + params["pos_dec"][:S][None]
    x = shard(x, "batch", "seq_res", "embed")

    def body(x, lw):
        h = layer_norm(x, lw["ln1"], lw["ln1_b"])
        x = x + _mha(h, h, lw, cfg, causal=True)
        h = layer_norm(x, lw["lnx"], lw["lnx_b"])
        x = x + _mha(h, enc_out, lw, cfg, prefix="x_")
        h = layer_norm(x, lw["ln2"], lw["ln2_b"])
        return shard(x + _ffn(h, lw), "batch", "seq_res", "embed")

    for lw in layer_views(params["dec"], cfg.n_layers):
        x = remat_call(body, x, lw, remat=remat)
    if last_only:
        x = x[:, -1:]
    return shard(_head(params, x), "batch", "seq", "vocab")


def init_cache(cfg, batch: int, max_len: int, n_frames: int,
               device=None) -> dict:
    """Zeroed self-attention and cross-attention caches on ``device``
    (``None``: the card, ``RuntimeError`` without one).  Fill ``xk`` / ``xv``
    with :func:`precompute_cross_kv` before decoding."""
    device = resolve_device(device)
    d, L, H = cfg.d_model, cfg.n_layers, cfg.n_heads
    dh = d // H

    def zeros(T):
        return torch.zeros((L, batch, T, H, dh), dtype=DTYPE, device=device)

    return {"k": zeros(max_len), "v": zeros(max_len), "xk": zeros(n_frames),
            "xv": zeros(n_frames),
            "pos": torch.zeros((batch,), dtype=torch.int32, device=device)}


def precompute_cross_kv(params, enc_out, cfg):
    """Cross-attention K/V per decoder layer from the encoder output:
    (L, B, T, H, dh) each."""
    d = enc_out.shape[2]
    H = cfg.n_heads
    dh = d // H
    xk, xv = [], []
    for li in range(cfg.n_layers):
        lw = take_layer(params["dec"], li)
        xk.append(split_dim(enc_out @ lw["x_wk"], 2, (H, dh)))
        xv.append(split_dim(enc_out @ lw["x_wv"] + lw["x_bv"], 2, (H, dh)))
    return torch.stack(xk), torch.stack(xv)


def decode_step(params, cache, tokens, cfg):
    """One decoder token at position ``pos[0]`` (no ring: the cache holds
    ``max_len`` positions).  The caller's cache is left as it was."""
    B = tokens.shape[0]
    pos = cache["pos"]
    at = pos[:1].long()
    x = embed(params, tokens) + params["pos_dec"][at][None]
    H = cfg.n_heads
    dh = cfg.d_model // H
    k_all = cache["k"].clone()
    v_all = cache["v"].clone()
    for li in range(cfg.n_layers):
        lw = take_layer(params["dec"], li)
        xk, xv = cache["xk"][li], cache["xv"][li]
        h = layer_norm(x, lw["ln1"], lw["ln1_b"])
        q = split_dim(h @ lw["wq"] + lw["bq"], 2, (H, dh))
        k = split_dim(h @ lw["wk"], 2, (H, dh))
        v = split_dim(h @ lw["wv"] + lw["bv"], 2, (H, dh))
        write_slot(k_all[li], at, k)
        write_slot(v_all[li], at, v)
        o = decode_attention(q, k_all[li], v_all[li], pos[:1] + 1)
        x = x + o.reshape(B, 1, -1) @ lw["wo"] + lw["bo"]
        h = layer_norm(x, lw["lnx"], lw["lnx_b"])
        q = split_dim(h @ lw["x_wq"] + lw["x_bq"], 2, (H, dh))
        o = decode_attention(q, xk, xv, xk.shape[1])
        x = x + o.reshape(B, 1, -1) @ lw["x_wo"] + lw["x_bo"]
        h = layer_norm(x, lw["ln2"], lw["ln2_b"])
        x = x + _ffn(h, lw)
    new_cache = dict(cache, k=k_all, v=v_all, pos=pos + 1)
    return shard(_head(params, x), "batch", "seq", "vocab"), new_cache
