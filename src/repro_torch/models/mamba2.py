"""Mamba-2 (SSD) block, plain PyTorch, chunk-parallel.

Counterpart of ``repro/models/mamba2.py``: the state-space-duality form.
Within a chunk the output is a masked (decay-weighted) attention-like
matmul; across chunks a low-rank state (H, Dh, N) is carried.  All decay
exponents are differences of a monotone cumulative log-decay, hence <= 0:
stable in float32 without clamping.  Decode is the O(1) recurrent update
with a rolling depthwise-conv cache.  :mod:`.hybrid` (zamba2) composes
these blocks with a shared attention block.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.sim.replay_torch import resolve_device
from .layers import DTYPE, ParamSpec, local_call, rms_norm, shard, split_dim

__all__ = [
    "block_specs",
    "block_forward",
    "block_decode",
    "init_state",
    "dims",
    "ssd_chunked",
]

CONV_K = 4


def dims(cfg):
    d_inner = cfg.ssm_expand * cfg.d_model
    H = d_inner // cfg.ssm_head_dim
    G = cfg.ssm_groups
    N = cfg.ssm_state
    conv_dim = d_inner + 2 * G * N
    in_dim = 2 * d_inner + 2 * G * N + H
    return d_inner, H, G, N, conv_dim, in_dim


def block_specs(cfg, n_layers: int) -> dict:
    d = cfg.d_model
    d_inner, H, G, N, conv_dim, in_dim = dims(cfg)
    L = n_layers
    f32 = torch.float32
    return {
        "norm": ParamSpec((L, d), ("layers", "embed"), init="ones"),
        "in_proj": ParamSpec((L, d, in_dim), ("layers", "embed", "mlp")),
        "conv_w": ParamSpec((L, CONV_K, conv_dim), ("layers", None, "mlp")),
        "conv_b": ParamSpec((L, conv_dim), ("layers", "mlp"), init="zeros"),
        "A_log": ParamSpec((L, H), ("layers", None), dtype=f32, init="zeros"),
        "D": ParamSpec((L, H), ("layers", None), dtype=f32, init="ones"),
        "dt_bias": ParamSpec((L, H), ("layers", None), dtype=f32, init="zeros"),
        "out_norm": ParamSpec((L, d_inner), ("layers", "mlp"), init="ones"),
        "out_proj": ParamSpec((L, d_inner, d), ("layers", "mlp", "embed")),
    }


def _split_proj(x, lw, cfg):
    """z, xBC, dt: the in-projection's three blocks, each split over the
    model axis on its own (the mesh splits ``in_proj``'s output as one dim;
    GSPMD reshards each slice to its consumers' layout, where DTensor would
    leave the slices whole on every rank)."""
    d_inner, H, G, N, conv_dim, _ = dims(cfg)
    # split over the model axis, its gradient too: the slices' gradients
    # meet here whole
    zxbcdt = shard(x @ lw["in_proj"], "batch", None, "mlp")
    z = zxbcdt[..., :d_inner]
    xBC = zxbcdt[..., d_inner: d_inner + conv_dim]
    dt = zxbcdt[..., d_inner + conv_dim:]
    return (shard(z, "batch", None, "mlp"), shard(xBC, "batch", None, "mlp"),
            shard(dt, "batch", None, "heads"))


def _conv(xBC, lw, cache=None):
    """Causal depthwise conv, kernel CONV_K. cache: (B, K-1, conv_dim)."""
    if cache is None:
        pad = xBC.new_zeros((xBC.shape[0], CONV_K - 1, xBC.shape[-1]))
    else:
        pad = cache.to(xBC.dtype)
    xp = torch.cat([pad, xBC], dim=1)
    S = xBC.shape[1]
    y = sum(xp[:, j: j + S] * lw["conv_w"][j] for j in range(CONV_K)) \
        + lw["conv_b"]
    new_cache = xp[:, -(CONV_K - 1):]
    return F.silu(y.float()).to(xBC.dtype), new_cache


def _ssm_inputs(xBC, dt, lw, cfg):
    d_inner, H, G, N, _, _ = dims(cfg)
    xs = shard(split_dim(xBC[..., :d_inner], 2, (H, cfg.ssm_head_dim)),
               "batch", None, "heads", None)
    Bm = split_dim(xBC[..., d_inner: d_inner + G * N], 2, (G, N))
    Cm = split_dim(xBC[..., d_inner + G * N:], 2, (G, N))
    rep = H // G
    # every head of a rank's block reads its group's B and C
    Bh, Ch = (shard(torch.repeat_interleave(t, rep, dim=2), "batch", None,
                    "heads", None) for t in (Bm, Cm))       # (B,S,H,N)
    dt = F.softplus(dt.float() + lw["dt_bias"])             # (B,S,H)
    la = -torch.exp(lw["A_log"]) * dt                       # log a_t <= 0
    xbar = xs.float() * dt[..., None]                       # dt-scaled input
    return xs, xbar, Bh.float(), Ch.float(), la


def ssd_chunked(xbar, Bh, Ch, la, chunk: int, state0=None, unroll: int = 0):
    """Chunk-parallel SSD. All args float32.

    xbar: (B,S,H,Dh); Bh/Ch: (B,S,H,N); la: (B,S,H) log-decay.
    Returns (y (B,S,H,Dh), final_state (B,H,Dh,N)).  ``S`` is padded to a
    multiple of ``min(chunk, S)`` with identity steps (la = 0, xbar = 0);
    ``unroll`` is accepted and ignored.
    """
    B_, S, H, Dh = xbar.shape
    N = Bh.shape[-1]
    Q = min(chunk, S)
    nc = (S + Q - 1) // Q
    if nc * Q != S:
        pad = nc * Q - S
        xbar, Bh, Ch = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (xbar, Bh, Ch))
        la = F.pad(la, (0, 0, 0, pad))
    # inclusive: D_ii = 1 (the reference's tril with k=0)
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                 device=xbar.device))[None, :, :, None]
    S_prev = (torch.zeros((B_, H, Dh, N), dtype=torch.float32,
                          device=xbar.device) if state0 is None else state0)
    ys = []
    for c0 in range(0, nc * Q, Q):
        xc, Bc, Cc, lac = (t[:, c0:c0 + Q] for t in (xbar, Bh, Ch, la))
        cum = torch.cumsum(lac, dim=1)                       # (B,Q,H)
        # intra-chunk masked decay attention: D_ij = exp(cum_i - cum_j), i>=j
        dmat = cum[:, :, None, :] - cum[:, None, :, :]       # (B,i,j,H)
        dmat = torch.where(mask, dmat, -torch.inf)
        scores = torch.einsum("bihn,bjhn->bijh", Cc, Bc) * torch.exp(dmat)
        y = torch.einsum("bijh,bjhd->bihd", scores, xc)
        # contribution of the carried state + state update
        y = y + torch.einsum("bihn,bhdn->bihd",
                             Cc * torch.exp(cum)[..., None], S_prev)
        decay_end = torch.exp(cum[:, -1:, :] - cum)          # (B,Q,H)
        S_prev = S_prev * torch.exp(cum[:, -1])[..., None, None] + torch.einsum(
            "bjhn,bjhd->bhdn", Bc * decay_end[..., None], xc)
        ys.append(y)
    return torch.cat(ys, dim=1)[:, :S], S_prev


def _gate_out(y, z, x, lw, d_inner):
    """D skip already added: gate by silu(z), out_norm, out_proj, residual."""
    y = y.reshape(*x.shape[:2], d_inner)
    y = rms_norm((y * F.silu(z.float())).to(DTYPE), lw["out_norm"])
    return x + shard(y @ lw["out_proj"], "batch", "seq_res", "embed")


def block_forward(x, lw, cfg, state0=None, conv_cache=None):
    """Full Mamba-2 block: norm -> proj -> conv -> SSD -> gate -> out.

    x: (B,S,d). Returns (out (B,S,d), (final_state, conv_cache)).
    """
    d_inner = dims(cfg)[0]
    h = rms_norm(x, lw["norm"])
    z, xBC, dt = _split_proj(h, lw, cfg)
    xBC, new_conv = _conv(xBC, lw, conv_cache)
    xs, xbar, Bh, Ch, la = _ssm_inputs(xBC, dt, lw, cfg)
    # on a mesh each rank runs its own (batch, head) block: the chunk loop's
    # ops are shard-local, as in the reference's layout
    ax, st = ("batch", None, "heads", None), ("batch", "heads", None, None)
    y, final = local_call(
        lambda xb, b, c, la, s0: ssd_chunked(xb, b, c, la, cfg.ssm_chunk, s0),
        (ax, ax, ax, ax[:3], None if state0 is None else st), (ax, st),
        xbar, Bh, Ch, la, state0)
    y = y + lw["D"][:, None] * xs.float()
    return _gate_out(y, z, x, lw, d_inner), (final, new_conv)


def init_state(cfg, batch: int, n_layers: int, device=None):
    """Zeroed SSM states and conv caches on ``device`` (``None``: the card,
    ``RuntimeError`` without one)."""
    device = resolve_device(device)
    d_inner, H, G, N, conv_dim, _ = dims(cfg)
    return {
        "ssm": torch.zeros((n_layers, batch, H, cfg.ssm_head_dim, N),
                           dtype=torch.float32, device=device),
        "conv": torch.zeros((n_layers, batch, CONV_K - 1, conv_dim),
                            dtype=DTYPE, device=device),
    }


def block_decode(x, lw, cfg, state, conv_cache):
    """One-token recurrent update. x: (B,1,d)."""
    d_inner = dims(cfg)[0]
    h = rms_norm(x, lw["norm"])
    z, xBC, dt = _split_proj(h, lw, cfg)
    xBC, new_conv = _conv(xBC, lw, conv_cache)
    xs, xbar, Bh, Ch, la = _ssm_inputs(xBC, dt, lw, cfg)
    a = torch.exp(la[:, 0])                                  # (B,H)
    new_state = state * a[..., None, None] \
        + xbar[:, 0, :, :, None] * Bh[:, 0, :, None, :]
    y = torch.einsum("bhn,bhdn->bhd", Ch[:, 0], new_state)
    y = y + lw["D"][None, :, None] * xs[:, 0].float()
    return _gate_out(y, z, x, lw, d_inner), (new_state, new_conv)
