"""Shared building blocks of the port's model stack, in plain PyTorch.

Counterpart of ``repro/models/layers.py`` for the model stack: parameter
specs and their initialisation, the norms, rotary embeddings, the MLP,
prefill attention (one dense block, or the blockwise online-softmax forward
for long sequences) and single-token attention over a contiguous cache.

Conventions
-----------
* Parameters are nested dicts of tensors; each model's ``param_specs(cfg)``
  returns the same nesting of :class:`ParamSpec`, with the reference's shapes
  and logical axis names, so a reference parameter tree carries over leaf for
  leaf (:mod:`repro_torch.models.convert`).
* Every function keeps the reference's operation order and float32 upcasts;
  with the same parameters the two packages differ only by the order in which
  sums are rounded.
* The layer stack is a Python loop over the leading ``layers`` axis (PyTorch
  runs eagerly; nothing is scanned).

Not ported yet: the sharding helpers (``shard``, ``mesh_context``,
``param_shardings``, ``logical_to_pspec``; ROADMAP A16) and the hand-written
backward of blockwise attention (the training slice, A15).  ``attention``
takes no ``unroll``: it only shaped the reference's scanned loop.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch
import torch.nn.functional as F

__all__ = [
    "ParamSpec",
    "init_params",
    "map_tree",
    "take_layer",
    "embed",
    "rms_norm",
    "layer_norm",
    "rope",
    "attention",
    "decode_attention",
    "mlp",
    "DTYPE",
]

DTYPE = torch.bfloat16


@dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]          # logical axis names per dim
    dtype: Any = DTYPE
    init: str = "fan_in"                  # fan_in | zeros | ones | embed

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def _init_one(spec: ParamSpec, gen: torch.Generator) -> torch.Tensor:
    dev = gen.device
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=spec.dtype, device=dev)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=spec.dtype, device=dev)
    if spec.init == "embed":
        # 1/sqrt(d) keeps tied-head logits O(1) at init (CE ~ ln V)
        scale = 1.0 / math.sqrt(max(spec.shape[-1], 1))
    else:  # fan_in: scale by the penultimate (input) dimension
        fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
        scale = 1.0 / math.sqrt(max(fan_in, 1))
    # scaled in place: a leaf's peak is one float32 draw beside its result
    # (deepseek-moe-16b's experts.wi_gate is 20.7 GB of float32)
    draw = torch.randn(spec.shape, generator=gen, dtype=torch.float32,
                       device=dev)
    return draw.mul_(scale).to(spec.dtype)


def init_params(specs, generator: torch.Generator) -> dict:
    """Materialize a ParamSpec tree into tensors on ``generator.device``.

    Leaves are drawn one after another from ``generator`` in sorted-key
    order.  The draws are not the reference's (its keys are threefry); carry
    a reference tree over with :func:`repro_torch.models.convert.params_from_numpy`
    when the same numbers are needed.
    """
    if isinstance(specs, ParamSpec):
        return _init_one(specs, generator)
    return {k: init_params(specs[k], generator) for k in sorted(specs)}


def map_tree(fn, tree):
    """``fn`` applied to every leaf of a nested dict (parameter and spec
    trees)."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    return fn(tree)


def take_layer(tree, i: int):
    """Views of entry ``i`` along the leading (stacked ``layers``) axis of
    every leaf of ``tree``."""
    return map_tree(lambda a: a[i], tree)


def embed(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    """Rows of ``params["embed"]`` (in :data:`DTYPE`) for integer tokens."""
    return params["embed"].to(DTYPE)[tokens.long()]


# ---------------------------------------------------------------------------
# Normalization
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * gamma


def layer_norm(
    x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype) * gamma + beta


# ---------------------------------------------------------------------------
# Rotary position embedding
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 1e4) -> torch.Tensor:
    """Apply RoPE. x: (..., seq, heads, head_dim); positions: (..., seq)."""
    half = x.shape[-1] // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freqs = theta ** exps
    angles = positions[..., :, None].float() * freqs  # (..., seq, hd/2)
    angles = angles[..., :, None, :]  # broadcast over heads
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (prefill: dense or blockwise-causal; decode: cached)
# ---------------------------------------------------------------------------

def attention(
    q: torch.Tensor,             # (B, S, Hq, D)
    k: torch.Tensor,             # (B, S, Hkv, D)
    v: torch.Tensor,             # (B, S, Hkv, D)
    *,
    causal: bool = True,
    sliding_window: int | None = None,
    block_kv: int = 1024,
) -> torch.Tensor:
    """Grouped-query attention for a whole sequence.

    ``S <= block_kv``: one dense block.  Otherwise KV is processed in chunks
    of ``block_kv`` with an online softmax, so the S x S score matrix is never
    formed (the forward of the reference's blockwise attention).  Query heads
    stay grouped (B, S, Hkv, rep, D), so repeated KV is never formed.
    """
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    rep = Hq // Hkv
    if S <= block_kv:  # small enough: single dense block
        scale = 1.0 / math.sqrt(D)
        qg = q.reshape(B, S, Hkv, rep, D).float() * scale
        return _attn_dense(qg, k, v, causal, sliding_window).to(q.dtype)
    win = 0 if sliding_window is None else int(sliding_window)
    return _flash_fwd(q, k, v, bool(causal), win, int(block_kv))


def _flash_mask(q_pos, kv_pos, causal: bool, win: int, S: int):
    mask = (kv_pos < S)[None, :]
    if causal:
        mask = mask & (q_pos[:, None] >= kv_pos[None, :])
    if win:
        mask = mask & (q_pos[:, None] - kv_pos[None, :] < win)
    return mask


def _flash_fwd(q, k, v, causal, win, block_kv):
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    rep = Hq // Hkv
    scale = 1.0 / math.sqrt(D)
    qg = q.reshape(B, S, Hkv, rep, D).float() * scale
    nb = (S + block_kv - 1) // block_kv
    pad = nb * block_kv - S
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    dev = q.device
    q_pos = torch.arange(S, device=dev)
    acc = torch.zeros((B, Hkv, rep, S, D), dtype=torch.float32, device=dev)
    m = torch.full((B, Hkv, rep, S), -math.inf, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Hkv, rep, S), dtype=torch.float32, device=dev)
    for blk in range(nb):
        kb = k[:, blk * block_kv:(blk + 1) * block_kv].float()
        vb = v[:, blk * block_kv:(blk + 1) * block_kv].float()
        kv_pos = blk * block_kv + torch.arange(block_kv, device=dev)
        s_ij = torch.einsum("bqhrd,bkhd->bhrqk", qg, kb)
        mask = _flash_mask(q_pos, kv_pos, causal, win, S)
        s_ij = torch.where(mask[None, None, None], s_ij, -math.inf)
        m_new = torch.maximum(m, s_ij.amax(dim=-1))
        m_safe = torch.where(torch.isinf(m_new), 0.0, m_new)
        p = torch.where(torch.isinf(s_ij), 0.0,
                        torch.exp(s_ij - m_safe[..., None]))
        corr = torch.where(torch.isinf(m), 0.0, torch.exp(m - m_safe))
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhrqk,bkhd->bhrqd", p, vb)
        m = m_new
    out = acc / torch.clamp(l, min=1e-37)[..., None]      # (B,Hkv,rep,S,D)
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, Hq, D).to(q.dtype)


def _attn_dense(qg, k, v, causal, sliding_window):
    """qg: (B,S,Hkv,rep,D) fp32 pre-scaled; k, v: (B,S,Hkv,D)."""
    B, S, Hkv, rep, D = qg.shape
    s = torch.einsum("bqhrd,bkhd->bhrqk", qg, k.float())
    q_pos = torch.arange(S, device=qg.device)
    mask = torch.ones((S, S), dtype=torch.bool, device=qg.device)
    if causal:
        mask &= q_pos[:, None] >= q_pos[None, :]
    if sliding_window is not None:
        mask &= q_pos[:, None] - q_pos[None, :] < sliding_window
    s = torch.where(mask[None, None, None], s, -math.inf)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhrqk,bkhd->bqhrd", p, v.float())
    return out.reshape(B, S, Hkv * rep, D)


def decode_attention(
    q: torch.Tensor,             # (B, 1, Hq, D)
    k_cache: torch.Tensor,       # (B, S_max, Hkv, D)
    v_cache: torch.Tensor,
    cache_len,                   # int or (B,) valid lengths
) -> torch.Tensor:
    """Single-token attention against a KV cache.

    Works unchanged for sliding-window ring buffers: keys are stored
    post-RoPE with absolute positions, so scores depend only on relative
    position and the physical slot order inside the ring is irrelevant;
    the window is enforced by the ring size and ``cache_len`` counts
    valid (written) slots clamped to the ring capacity.
    """
    B, S_max, Hkv, D = k_cache.shape
    Hq = q.shape[2]
    n_rep = Hq // Hkv
    scale = 1.0 / math.sqrt(D)
    qf = q.float() * scale                        # (B, 1, Hq, D)
    kf = k_cache.float()
    vf = v_cache.float()
    if n_rep > 1:
        qf = qf.reshape(B, 1, Hkv, n_rep, D)
        s = torch.einsum("bqhrd,bkhd->bhrqk", qf, kf)   # (B,Hkv,rep,1,S)
    else:
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kf)[:, :, None]
    idx = torch.arange(S_max, device=q.device)
    lens = torch.as_tensor(cache_len, device=q.device).reshape(-1, 1)
    valid = idx[None, :] < lens
    s = torch.where(valid[:, None, None, None, :], s, -math.inf)
    p = torch.softmax(s, dim=-1)
    p = torch.where(torch.isnan(p), 0.0, p)       # fully-masked rows
    out = torch.einsum("bhrqk,bkhd->bqhrd", p, vf)
    return out.reshape(B, 1, Hq, D).to(q.dtype)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def mlp(x: torch.Tensor, w: dict, kind: str = "swiglu") -> torch.Tensor:
    """SwiGLU (w: wi_gate, wi_up, wo) or GELU (w: wi, wo) feed-forward."""
    if kind == "swiglu":
        g = x @ w["wi_gate"]
        u = x @ w["wi_up"]
        h = F.silu(g.float()).to(x.dtype) * u
    else:
        h = x @ w["wi"]
        h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    return h @ w["wo"]
