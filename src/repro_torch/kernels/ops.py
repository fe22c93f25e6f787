"""Public entry points of the port's attention kernels.

Each picks the hand-written CUDA kernel for a CUDA tensor and the plain
PyTorch version (:mod:`.ref`) for a CPU tensor, by ``q.is_cuda`` and nothing
else.  ``flash_attention`` and ``wkv6`` join this module in the slice that
ports them (ROADMAP B3, B5).
"""
from __future__ import annotations

from . import paged_kv_gather
from .ref import paged_decode_attention_ref

__all__ = ["paged_decode_attention"]


def paged_decode_attention(q, k_pages, v_pages, block_tables, lengths,
                           n_buffers: int = 2):
    """Decode attention over a slow-tier page store with a prefetch ring of
    ``n_buffers`` pages (the paper's prefetch depth P)."""
    if q.is_cuda:
        return paged_kv_gather.paged_decode_attention(
            q, k_pages, v_pages, block_tables, lengths, n_buffers=n_buffers)
    return paged_decode_attention_ref(q, k_pages, v_pages, block_tables,
                                      lengths)
