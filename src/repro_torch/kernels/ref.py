"""Plain PyTorch versions of the port's attention kernels (the correctness
ground truth on the card, and what a CPU tensor runs).

Each ``*_ref`` is a direct, unoptimized statement of the math, the same as the
reference's ``repro/kernels/ref.py``.
"""
from __future__ import annotations

import math

import torch

__all__ = ["paged_decode_attention_ref"]


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
    # gather each sequence's pages into a contiguous (B, ppseq*page, Hkv, D)
    bt = block_tables.long()
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
