"""RWKV-6 "Finch" (attention-free, data-dependent per-channel decay), plain
PyTorch.

Counterpart of ``repro/models/rwkv6.py``.  Time-mix: WKV linear recurrence
with matrix state S (head: key-dim x value-dim) and data-dependent diagonal
decay w_t produced by a token-shift LoRA; bonus term u for the current
token.  Channel-mix: token-shifted squared-ReLU FFN with sigmoid receptance.

The forward is chunk-parallel (:func:`wkv_chunked`): within a chunk of Q
tokens the pairwise decay tensor exp(ce_i - c_j) (i > j) is formed
explicitly per (Q, Q, Dh); every exponent is a difference of a monotone
cumulative log-decay, hence <= 0, so it is the recurrence, float32-stable,
with no clamping.  Decode is the O(1) per-token state update.  As in the
reference, the model runs :func:`wkv_chunked` and never the wkv6 kernel
(``kernels.ops.wkv6``).  The layer stack is a Python loop; ``remat``
recomputes each layer in the backward, and ``unroll`` is accepted and
ignored.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.sim.replay_torch import resolve_device
from .layers import (DTYPE, ParamSpec, embed, layer_norm, layer_views,
                     local_call, merge_dims, reduce_proj, remat_call, shard,
                     split_dim, take_layer)

__all__ = ["param_specs", "forward", "decode_step", "init_state",
           "wkv_chunked"]

TM_LORA = 32     # token-shift mixing LoRA rank
TD_LORA = 64     # decay LoRA rank


def _layer_specs(cfg) -> dict:
    d, ff, L = cfg.d_model, cfg.d_ff, cfg.n_layers
    H, Dh = cfg.n_rwkv_heads, cfg.rwkv_head_dim
    return {
        "ln1": ParamSpec((L, d), ("layers", "embed"), init="ones"),
        "ln1_b": ParamSpec((L, d), ("layers", "embed"), init="zeros"),
        "ln2": ParamSpec((L, d), ("layers", "embed"), init="ones"),
        "ln2_b": ParamSpec((L, d), ("layers", "embed"), init="zeros"),
        # time-mix
        "maa_x": ParamSpec((L, d), ("layers", "embed"), init="zeros"),
        "maa_wkvrg": ParamSpec((L, 5, d), ("layers", None, "embed"), init="zeros"),
        "maa_w1": ParamSpec((L, d, 5 * TM_LORA), ("layers", "embed", None)),
        "maa_w2": ParamSpec((L, 5, TM_LORA, d), ("layers", None, None, "embed")),
        "decay_base": ParamSpec((L, d), ("layers", "embed"), init="zeros"),
        "decay_w1": ParamSpec((L, d, TD_LORA), ("layers", "embed", None)),
        "decay_w2": ParamSpec((L, TD_LORA, d), ("layers", None, "embed")),
        "bonus_u": ParamSpec((L, H, Dh), ("layers", None, None), init="zeros"),
        "wr": ParamSpec((L, d, d), ("layers", "embed", "heads_flat")),
        "wk": ParamSpec((L, d, d), ("layers", "embed", "heads_flat")),
        "wv": ParamSpec((L, d, d), ("layers", "embed", "heads_flat")),
        "wg": ParamSpec((L, d, d), ("layers", "embed", "heads_flat")),
        "wo": ParamSpec((L, d, d), ("layers", "heads_flat", "embed")),
        "gn": ParamSpec((L, d), ("layers", "embed"), init="ones"),
        "gn_b": ParamSpec((L, d), ("layers", "embed"), init="zeros"),
        # channel-mix
        "cm_maa_k": ParamSpec((L, d), ("layers", "embed"), init="zeros"),
        "cm_maa_r": ParamSpec((L, d), ("layers", "embed"), init="zeros"),
        "cm_wk": ParamSpec((L, d, ff), ("layers", "embed", "mlp")),
        "cm_wv": ParamSpec((L, ff, d), ("layers", "mlp", "embed")),
        "cm_wr": ParamSpec((L, d, d), ("layers", "embed", "embed2")),
    }


def param_specs(cfg) -> dict:
    d = cfg.d_model
    return {
        "embed": ParamSpec((cfg.vocab, d), ("vocab", "embed"), init="embed"),
        "ln_in": ParamSpec((d,), ("embed",), init="ones"),
        "ln_in_b": ParamSpec((d,), ("embed",), init="zeros"),
        "layers": _layer_specs(cfg),
        "final_norm": ParamSpec((d,), ("embed",), init="ones"),
        "final_norm_b": ParamSpec((d,), ("embed",), init="zeros"),
        "lm_head": ParamSpec((d, cfg.vocab), ("embed", "vocab")),
    }


def _time_mix_inputs(x, x_prev, lw):
    """Token-shift DDLerp -> (xk, xv, xr, xg) and decay w (log-space)."""
    sx = x_prev - x
    xxx = x + sx * lw["maa_x"]
    lo = split_dim(torch.tanh(xxx @ lw["maa_w1"]), 2, (5, TM_LORA))
    mix = torch.einsum("bsfr,frd->bsfd", lo, lw["maa_w2"]) + lw["maa_wkvrg"]
    xs = x[:, :, None] + sx[:, :, None] * mix              # (B,S,5,d)
    # the five mixes are whole on every rank before they are taken apart
    # (DTensor may shard the 5 on a mesh, and cannot unbind a sharded dim)
    xw, xk, xv, xr, xg = shard(xs, "batch", None, None, "embed").unbind(2)
    dec = lw["decay_base"] + torch.tanh(xw @ lw["decay_w1"]) @ lw["decay_w2"]
    log_w = -torch.exp(dec.float())                        # log w_t <= 0
    return xk, xv, xr, xg, log_w


def wkv_chunked(r, k, v, log_w, u, chunk: int, state0=None, unroll: int = 0):
    """Chunk-parallel WKV. r,k,v: (B,S,H,Dh); log_w: (B,S,H,Dh) <= 0.

    out_t = r_t . (S_{t-1} + (u * k_t) v_t^T);  S_t = diag(w_t) S_{t-1} + k_t v_t^T
    Returns (out (B,S,H,Dh_v), final_state (B,H,Dh,Dh) float32).  ``S`` is
    padded to a multiple of ``Q = min(chunk, S)`` with zero steps, as in the
    reference; ``unroll`` is accepted and ignored.
    """
    B, S, H, Dh = r.shape
    Q = min(chunk, S)
    nc = (S + Q - 1) // Q
    if nc * Q != S:
        pad = (0, 0, 0, 0, 0, nc * Q - S)
        r, k, v, log_w = (F.pad(t, pad) for t in (r, k, v, log_w))
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=r.device),
                      diagonal=-1)[None, :, :, None, None]
    S_prev = (torch.zeros((B, H, Dh, Dh), dtype=torch.float32, device=r.device)
              if state0 is None else state0)
    ys = []
    for c0 in range(0, nc * Q, Q):
        rc, kc, vc, lwc = (t[:, c0:c0 + Q] for t in (r, k, v, log_w))
        c = torch.cumsum(lwc, dim=1)                       # inclusive
        ce = c - lwc                                       # exclusive
        # intra-chunk: s_ij = sum_d r_i k_j exp(ce_i - c_j), strictly i > j;
        # ce_i - c_j <= 0 for i > j, so every exponent is stable.
        dmat = ce[:, :, None] - c[:, None, :]              # (B,i,j,H,Dh)
        dexp = torch.where(mask, torch.exp(dmat), 0.0)
        s = (rc[:, :, None] * kc[:, None] * dexp).sum(-1)  # (B,i,j,H)
        y = torch.einsum("bijh,bjhe->bihe", s, vc)
        diag = (rc * (kc * u)).sum(-1)                     # (B,i,H)
        y = y + diag[..., None] * vc
        # inter-chunk contribution + state carry
        y = y + torch.einsum("bihd,bhde->bihe", rc * torch.exp(ce), S_prev)
        total = torch.exp(c[:, -1])                        # (B,H,Dh)
        kdec = kc * torch.exp(c[:, -1:] - c)
        S_prev = S_prev * total[..., None] + torch.einsum(
            "bjhd,bjhe->bhde", kdec, vc)
        ys.append(y)
    return torch.cat(ys, dim=1)[:, :S], S_prev


def _heads(t, H, Dh):
    return split_dim(t, 2, (H, Dh)).float()


def _wkv_inputs(x, x_prev, lw, cfg):
    """The recurrence's inputs of one layer: r, k, v (B,S,H,Dh) float32,
    the gate g (B,S,d), log_w (B,S,H,Dh) float32 and u (H,Dh) float32."""
    H, Dh = cfg.n_rwkv_heads, cfg.rwkv_head_dim
    xk, xv, xr, xg, log_w = _time_mix_inputs(x, x_prev, lw)
    r = _heads(xr @ lw["wr"], H, Dh)
    k = _heads(xk @ lw["wk"], H, Dh)
    v = _heads(xv @ lw["wv"], H, Dh)
    g = xg @ lw["wg"]
    lwh = split_dim(log_w, 2, (H, Dh))
    return r, k, v, g, lwh, lw["bonus_u"].float()


def _time_mix(x, x_prev, lw, cfg, state0=None, decode=False):
    H, Dh = cfg.n_rwkv_heads, cfg.rwkv_head_dim
    r, k, v, g, lwh, u = _wkv_inputs(x, x_prev, lw, cfg)
    if decode:
        state = state0
        kv_u = (u[None] * k[:, 0])[..., None] * v[:, 0, :, None, :]
        out_t = torch.einsum("bhd,bhde->bhe", r[:, 0], state + kv_u)
        new_state = state * torch.exp(lwh[:, 0])[..., None] \
            + k[:, 0, :, :, None] * v[:, 0, :, None, :]
        y, final = out_t[:, None], new_state
    else:
        # on a mesh each rank runs its own (batch, head) block: the chunk
        # loop's ops are shard-local, as in the reference's layout (heads
        # the mesh does not divide are split as GSPMD splits them)
        ax, heads = ("batch", None, "heads", None), "heads"
        y, final = local_call(
            lambda r, k, v, lw, u, s0: wkv_chunked(r, k, v, lw, u,
                                                   cfg.ssm_chunk, s0),
            (ax, ax, ax, ax, (heads, None),
             None if state0 is None else ("batch", heads, None, None)),
            (ax, ("batch", heads, None, None)), r, k, v, lwh, u, state0)
    y = merge_dims(y, 2).to(DTYPE)
    # per-head group norm == LayerNorm over each head's channels
    yh = split_dim(y, 2, (H, Dh)).float()
    mu = yh.mean(-1, keepdim=True)
    var = yh.var(-1, keepdim=True, unbiased=False)
    yh = (yh - mu) * torch.rsqrt(var + 64e-5)
    y = merge_dims(yh, 2).to(DTYPE) * lw["gn"] + lw["gn_b"]
    y = y * F.silu(g.float()).to(DTYPE)
    # on a mesh the heads' partial sums are reduced here, not carried into
    # the residual (a partial residual would run the channel mix on whole
    # weights)
    return reduce_proj(y, lw["wo"], "batch", "seq_res", "embed"), final


def _channel_mix(x, x_prev, lw):
    sx = x_prev - x
    xk = x + sx * lw["cm_maa_k"]
    xr = x + sx * lw["cm_maa_r"]
    kk = torch.square(F.relu((xk @ lw["cm_wk"]).float())).to(DTYPE)
    kk = shard(kk, "batch", "seq", "mlp")
    vv = reduce_proj(kk, lw["cm_wv"], "batch", "seq_res", "embed")
    rr = torch.sigmoid((xr @ lw["cm_wr"]).float())
    return rr.to(DTYPE) * vv


def _shift(x, last=None):
    """x_prev: previous token's activations (zero or carried for decode)."""
    if last is None:
        return F.pad(x[:, :-1], (0, 0, 1, 0))
    if x.shape[1] == 1:
        return last[:, None]
    return torch.cat([last[:, None], x[:, :-1]], dim=1)


def _layer(x, lw, cfg, st=None, decode=False):
    """st: None (forward) or dict(tm_state, tm_last, cm_last)."""
    h = layer_norm(x, lw["ln1"], lw["ln1_b"])
    h_prev = _shift(h, st["tm_last"] if decode else None)
    tm, new_state = _time_mix(
        h, h_prev, lw, cfg, st["tm_state"] if decode else None, decode
    )
    x = x + tm
    h2 = layer_norm(x, lw["ln2"], lw["ln2_b"])
    h2_prev = _shift(h2, st["cm_last"] if decode else None)
    x = x + _channel_mix(h2, h2_prev, lw)
    new_st = {
        "tm_state": new_state,
        "tm_last": h[:, -1],
        "cm_last": h2[:, -1],
    }
    return shard(x, "batch", "seq_res", "embed"), new_st


def _head(params, x):
    x = layer_norm(x, params["final_norm"], params["final_norm_b"])
    return x @ params["lm_head"]


def forward(params, tokens, cfg, prefix_embeds=None, remat: bool = True,
            last_only: bool = False):
    """Teacher-forced forward -> logits (B, S, vocab)."""
    x = embed(params, tokens)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(DTYPE), x], dim=1)
    x = layer_norm(x, params["ln_in"], params["ln_in_b"])
    x = shard(x, "batch", "seq_res", "embed")
    body = lambda x, lw: _layer(x, lw, cfg)[0]
    for lw in layer_views(params["layers"], cfg.n_layers):
        x = remat_call(body, x, lw, remat=remat)
    if last_only:
        x = x[:, -1:]
    return shard(_head(params, x), "batch", "seq", "vocab")


def init_state(cfg, batch: int, device=None) -> dict:
    """Zeroed recurrent state on ``device`` (``None``: the card,
    ``RuntimeError`` without one; pass ``device="cpu"`` for the host)."""
    device = resolve_device(device)
    H, Dh, d, L = cfg.n_rwkv_heads, cfg.rwkv_head_dim, cfg.d_model, cfg.n_layers
    return {
        "tm_state": torch.zeros((L, batch, H, Dh, Dh), dtype=torch.float32,
                                device=device),
        "tm_last": torch.zeros((L, batch, d), dtype=DTYPE, device=device),
        "cm_last": torch.zeros((L, batch, d), dtype=DTYPE, device=device),
        "pos": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def decode_step(params, state, tokens, cfg):
    """One token: tokens (B, 1) -> (logits (B, 1, vocab), new state).  The
    caller's state is left as it was."""
    x = layer_norm(embed(params, tokens), params["ln_in"], params["ln_in_b"])
    new = {"tm_state": [], "tm_last": [], "cm_last": []}
    for li in range(cfg.n_layers):
        st = {key: state[key][li] for key in new}
        x, st = _layer(x, take_layer(params["layers"], li), cfg, st,
                       decode=True)
        for key in new:
            new[key].append(st[key])
    logits = shard(_head(params, x), "batch", "seq", "vocab")
    new_state = {key: torch.stack(vals) for key, vals in new.items()}
    new_state["pos"] = state["pos"] + 1
    return logits, new_state
