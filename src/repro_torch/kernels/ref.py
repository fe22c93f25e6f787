"""Plain PyTorch versions of the port's attention-family kernels -- flash
attention, paged decode attention, the RWKV-6 WKV recurrence (the
correctness ground truth on the card, and what a CPU tensor runs).

Each ``*_ref`` is a direct, unoptimized statement of the math, the same as the
reference's ``repro/kernels/ref.py``.
"""
from __future__ import annotations

import math

import torch

__all__ = ["flash_attention_ref", "paged_decode_attention_ref", "wkv6_ref"]


def flash_attention_ref(
    q: torch.Tensor,             # (B, S, Hq, D)
    k: torch.Tensor,             # (B, S, Hkv, D)
    v: torch.Tensor,
    causal: bool = True,
    sliding_window: int | None = None,
) -> torch.Tensor:
    """Whole-sequence grouped-query attention; forms the S x S scores."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    rep = Hq // Hkv
    kk = torch.repeat_interleave(k, rep, dim=2)
    vv = torch.repeat_interleave(v, rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kk.float()) / math.sqrt(D)
    pos = torch.arange(S, device=q.device)
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= pos[:, None] >= pos[None, :]
    if sliding_window is not None:
        mask &= pos[:, None] - pos[None, :] < sliding_window
    s = torch.where(mask[None, None], s, -math.inf)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, vv.float())
    return out.to(q.dtype)


def paged_decode_attention_ref(
    q: torch.Tensor,             # (B, Hq, D) -- one new token per sequence
    k_pages: torch.Tensor,       # (P, page, Hkv, D) page store ("slow tier")
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,  # (B, pages_per_seq) int32
    lengths: torch.Tensor,       # (B,) valid tokens per sequence
) -> torch.Tensor:
    B, Hq, D = q.shape
    page = k_pages.shape[1]
    Hkv = k_pages.shape[2]
    rep = Hq // Hkv
    ppseq = block_tables.shape[1]
    # a page id is taken as the reference's gather takes an index: a
    # negative id wraps once, then the id is clamped into the store
    n_pages = k_pages.shape[0]
    bt = block_tables.long()
    bt = torch.where(bt < 0, bt + n_pages, bt).clamp(0, n_pages - 1)
    # gather each sequence's pages into a contiguous (B, ppseq*page, Hkv, D)
    k_seq = k_pages[bt].reshape(B, ppseq * page, Hkv, D)
    v_seq = v_pages[bt].reshape(B, ppseq * page, Hkv, D)
    kk = torch.repeat_interleave(k_seq, rep, dim=2)
    vv = torch.repeat_interleave(v_seq, rep, dim=2)
    s = torch.einsum("bhd,bkhd->bhk", q.float(), kk.float()) / math.sqrt(D)
    pos = torch.arange(ppseq * page, device=q.device)
    valid = pos[None, :] < lengths.to(q.device)[:, None]
    s = torch.where(valid[:, None, :], s, -math.inf)
    p = torch.softmax(s, dim=-1)
    p = torch.where(torch.isnan(p), 0.0, p)
    out = torch.einsum("bhk,bkhd->bhd", p, vv.float())
    return out.to(q.dtype)


def wkv6_ref(
    r: torch.Tensor,             # (B, S, H, D)
    k: torch.Tensor,
    v: torch.Tensor,
    log_w: torch.Tensor,         # (B, S, H, D), <= 0
    u: torch.Tensor,             # (H, D)
) -> torch.Tensor:
    """Sequential WKV recurrence (fp32):
    out_t = r_t . (S_{t-1} + (u*k_t) v_t^T);  S_t = diag(w_t) S_{t-1} + k_t v_t^T
    """
    B, S, H, D = r.shape
    rf, kf, vf = (x.float() for x in (r, k, v))
    wf = torch.exp(log_w.float())
    uf = u.float()
    state = torch.zeros((B, H, D, D), dtype=torch.float32, device=r.device)
    outs = []
    for t in range(S):
        kv = torch.einsum("bhd,bhe->bhde", kf[:, t], vf[:, t])
        outs.append(torch.einsum("bhd,bhde->bhe", rf[:, t],
                                 state + uf[None, :, :, None] * kv))
        state = state * wf[:, t, :, :, None] + kv
    if not outs:
        return torch.empty_like(r)
    return torch.stack(outs, dim=1).to(r.dtype)
