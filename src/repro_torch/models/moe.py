"""Mixture-of-Experts transformer (DeepSeekMoE / Qwen2-MoE style), plain
PyTorch.

Counterpart of ``repro/models/moe.py``.  Shared experts (always-on SwiGLU)
+ fine-grained routed experts with top-k softmax gating and capacity-based
token dropping (GShard discipline).  The dispatch is sort-based: expert id
and rank within the expert come from a stable argsort, and tokens are
scattered into a (G, E, C, d) buffer.  Routing ties go to the lower expert
index, as the reference's top-k breaks them (``torch.topk`` promises no
order, so the top k are taken from a stable descending sort).  On one device the
groups are only the reference's arithmetic: there is no expert parallelism.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .layers import (DTYPE, ParamSpec, embed, layer_views, local_call, mlp,
                     remat_call, shard, take_layer)
from . import transformer as tf

__all__ = ["param_specs", "forward", "decode_step", "init_cache", "moe_mlp",
           "padded_experts", "capacity", "n_groups"]


def padded_experts(cfg) -> int:
    """Routed experts padded to a multiple of 16, as in the reference
    (qwen2-moe's 60 -> 64; the 4 dead experts are masked out of routing and
    receive no tokens)."""
    return -(-cfg.n_experts // 16) * 16


def _moe_layer_specs(cfg) -> dict:
    sp = tf._layer_specs(cfg)
    L, d, fe = cfg.n_layers, cfg.d_model, cfg.d_expert
    E = padded_experts(cfg)
    fs = cfg.n_shared * cfg.d_expert
    sp["router"] = ParamSpec((L, d, E), ("layers", "embed", None),
                             dtype=torch.float32)
    sp["experts"] = {
        "wi_gate": ParamSpec((L, E, d, fe), ("layers", "expert", "embed", "expert_mlp")),
        "wi_up": ParamSpec((L, E, d, fe), ("layers", "expert", "embed", "expert_mlp")),
        "wo": ParamSpec((L, E, fe, d), ("layers", "expert", "expert_mlp", "embed")),
    }
    if cfg.n_shared:
        sp["shared"] = {
            "wi_gate": ParamSpec((L, d, fs), ("layers", "embed", "mlp")),
            "wi_up": ParamSpec((L, d, fs), ("layers", "embed", "mlp")),
            "wo": ParamSpec((L, fs, d), ("layers", "mlp", "embed")),
        }
    del sp["mlp"]
    return sp


def param_specs(cfg) -> dict:
    sp = tf.param_specs(cfg)
    sp["layers"] = _moe_layer_specs(cfg)
    return sp


def capacity(n_tokens: int, cfg) -> int:
    c = math.ceil(n_tokens * cfg.top_k / cfg.n_experts * cfg.capacity_factor)
    return max(min(n_tokens, max(c, 8)), 1)


def n_groups(T: int, cfg) -> int:
    """Largest group count <= moe_groups dividing T (the reference's
    data-parallel-aligned dispatch groups)."""
    g = min(cfg.moe_groups, T)
    while T % g:
        g -= 1
    return max(g, 1)


def route(xt, router, cfg):
    """Top-k routing of grouped tokens xt (G, Tg, d).

    Returns (probs (G, Tg, E) float32, gate_vals (G, Tg, k) renormalised,
    expert_idx (G, Tg, k) int64, aux) with the Switch-style load-balance
    loss over all groups."""
    E, k = padded_experts(cfg), cfg.top_k
    logits = xt.float() @ router
    if E != cfg.n_experts:  # mask padded (dead) experts out of routing
        dead = torch.arange(E, device=xt.device) >= cfg.n_experts
        logits = torch.where(dead, -math.inf, logits)
    probs = torch.softmax(logits, dim=-1)
    # the reference's top-k: descending, ties to the lower index
    srt, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, expert_idx = srt[..., :k], idx[..., :k]
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True)
    me = probs.mean(dim=(0, 1))
    ce = F.one_hot(expert_idx, E).float().sum(2).mean(dim=(0, 1)) / k
    aux = E * torch.sum(me * ce)
    return probs, gate_vals, expert_idx, aux


def dispatch_slots(flat_e, E: int, C: int):
    """Rank of each (token, choice) within its expert, per group, in token
    order: flat_e (G, Tg*k) -> (rank, keep = rank < C, dest = e*C +
    min(rank, C-1)).  A stable argsort plus a left ``searchsorted``, as in
    the reference."""
    G, n = flat_e.shape
    order = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = torch.gather(flat_e, -1, order)
    experts = torch.arange(E, device=flat_e.device).expand(G, E).contiguous()
    first = torch.searchsorted(sorted_e, experts)
    rank_sorted = torch.arange(n, device=flat_e.device) \
        - torch.gather(first, -1, sorted_e)
    rank = torch.zeros_like(flat_e).scatter_(-1, order, rank_sorted)
    keep = rank < C
    dest = flat_e * C + torch.clamp(rank, max=C - 1)
    return rank, keep, dest


def _group_local(fn, n_out: int, *args):
    """``fn(*args)`` for a function of each group (leading row) alone: on a
    mesh each rank runs it on its own groups, placed as the reference's
    ``expert_group`` (the reference's routing, dispatch and combine are
    shard-local; DTensor has no sharding rule for ``searchsorted`` or an
    accumulating ``index_put_``)."""
    grp = lambda a: ("expert_group",) + (None,) * (a.dim() - 1)
    first = next(a for a in args if isinstance(a, torch.Tensor))
    return local_call(fn, tuple(grp(a) if isinstance(a, torch.Tensor)
                                else None for a in args),
                      (grp(first),) * n_out, *args)


def _experts(buf, wi_gate, wi_up, wo):
    """The routed experts' SwiGLU over their dispatch buffer (G, E, C, d)."""
    gt = torch.einsum("gecd,edf->gecf", buf, wi_gate)
    up = torch.einsum("gecd,edf->gecf", buf, wi_up)
    h = F.silu(gt.float()).to(DTYPE) * up
    h = shard(h, "expert_group", "expert", None, "expert_mlp")
    return torch.einsum("gecf,efd->gecd", h, wo)


def _to_buffer(vals, dest, n_slots: int):
    """Each group's (n, d) ``vals`` added into rows ``dest`` of a zeroed
    (n_slots, d) buffer: (G, n, d) -> (G, n_slots, d)."""
    G, n, d = vals.shape
    g_idx = torch.arange(G, device=vals.device)[:, None].expand(G, n)
    buf = torch.zeros((G, n_slots, d), dtype=vals.dtype, device=vals.device)
    buf.index_put_((g_idx, dest), vals, accumulate=True)
    return buf


def _from_buffer(y, dest):
    """Rows ``dest`` of each group's buffer: (G, n_slots, d) -> (G, n, d)."""
    G, n = dest.shape
    g_idx = torch.arange(G, device=y.device)[:, None].expand(G, n)
    return y[g_idx, dest]


def moe_mlp(x: torch.Tensor, lw: dict, cfg) -> tuple[torch.Tensor, torch.Tensor]:
    """Routed + shared expert FFN. x: (B, S, d) -> (out, aux_loss).

    Grouped dispatch as in the reference: each group computes its own
    top-k, rank within expert and capacity.  A dropped token adds zeros to
    slot C-1 of its expert, so the capacity rule is the reference's."""
    B, S, d = x.shape
    T = B * S
    E, k = padded_experts(cfg), cfg.top_k
    G = n_groups(T, cfg)
    Tg = T // G
    C = capacity(Tg, cfg)
    xt = shard(x.reshape(G, Tg, d), "expert_group", None, "embed")
    _, gate_vals, expert_idx, aux = route(xt, lw["router"], cfg)
    flat_e = expert_idx.reshape(G, Tg * k)
    _, keep, dest = _group_local(dispatch_slots, 3, flat_e, E, C)
    tok = torch.arange(Tg * k, device=x.device) // k
    vals = torch.where(keep[..., None], xt[:, tok], 0).to(DTYPE)
    buf = _group_local(_to_buffer, 1, vals, dest, E * C)
    # group-major -> expert-major: the EP all-to-all happens here
    buf = shard(buf.reshape(G, E, C, d), "expert_group", "expert", None,
                "embed")

    ex = lw["experts"]
    # on a mesh each rank runs its (group, expert) block with the experts'
    # weights gathered over the FSDP axes
    blk, w = ("expert_group", "expert", None, "embed"), ("expert", None, None)
    y = local_call(_experts, (blk, w, w, w), (blk,), buf, ex["wi_gate"],
                   ex["wi_up"], ex["wo"])
    y = y.reshape(G, E * C, d)

    out_tok = _group_local(_from_buffer, 1, y, dest) * (
        keep[..., None] * gate_vals.reshape(G, Tg * k, 1)).to(DTYPE)
    # the reference's bfloat16 sum accumulates in float32 and rounds once
    routed = out_tok.reshape(G, Tg, k, d).float().sum(2).to(DTYPE)
    out = routed.reshape(T, d)
    if cfg.n_shared:
        # per token: the (B, S) rows are the reference's (1, T) rows, and
        # keep the batch axis a mesh shards
        out = out + mlp(x, lw["shared"], "swiglu").reshape(T, d)
    return out.reshape(B, S, d).to(x.dtype), aux


def _layer_body(x, lw, cfg, positions):
    x, _, _ = tf._attn_block(x, lw, cfg, positions)
    h = tf._norm(x, None, cfg, "mlp_norm", "mlp_norm_b", lw)
    y, aux = moe_mlp(h, lw, cfg)
    return shard(x + y, "batch", "seq_res", "embed"), aux


def forward(params, tokens, cfg, prefix_embeds=None, remat: bool = True,
            last_only: bool = False):
    """Returns (logits, aux_loss_mean over layers).  ``remat`` recomputes
    each layer in the backward."""
    x = embed(params, tokens)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(DTYPE), x], dim=1)
    B, S, _ = x.shape
    x = shard(x, "batch", "seq_res", "embed")
    positions = torch.arange(S, device=x.device).expand(B, S)
    auxes = []
    for lw in layer_views(params["layers"], cfg.n_layers):
        x, aux = remat_call(_layer_body, x, lw, cfg, positions, remat=remat)
        auxes.append(aux)
    if last_only:
        x = x[:, -1:]
    return (shard(tf._head(params, x, cfg), "batch", "seq", "vocab"),
            torch.stack(auxes).mean())


init_cache = tf.init_cache


def decode_step(params, cache, tokens, cfg):
    """One token through the MoE stack over a full or ring KV cache; the
    caller's cache is left as it was."""
    x = shard(embed(params, tokens), "batch", "seq_res", "embed")
    pos = cache["pos"]
    k_all = cache["k"].clone()
    v_all = cache["v"].clone()
    for li in range(cfg.n_layers):
        lw = take_layer(params["layers"], li)
        x = tf._decode_attn_block(x, lw, k_all[li], v_all[li], pos, cfg)
        h = tf._norm(x, None, cfg, "mlp_norm", "mlp_norm_b", lw)
        y, _ = moe_mlp(h, lw, cfg)
        x = x + y
    return (shard(tf._head(params, x, cfg), "batch", "seq", "vocab"),
            {"k": k_all, "v": v_all, "pos": pos + 1})
