"""Public entry points of the port's attention-family kernels, with the
reference's signatures and defaults (``repro/kernels/ops.py``).

Each picks the hand-written CUDA kernel for a CUDA tensor and the plain
PyTorch version (:mod:`.ref`) for a CPU tensor, by ``is_cuda`` of its first
argument and nothing else.
"""
from __future__ import annotations

from . import flash_attention as _flash
from . import paged_kv_gather
from . import wkv6 as _wkv6
from .ref import flash_attention_ref, paged_decode_attention_ref, wkv6_ref

__all__ = ["flash_attention", "paged_decode_attention", "wkv6"]


def flash_attention(q, k, v, causal: bool = True, sliding_window=None,
                    block_q: int = 256, block_k: int = 256):
    """(B, Hq, S, D) head-major flash attention; ``sliding_window`` None or
    0 means no window, as in the reference's kernel."""
    if q.is_cuda:
        return _flash.flash_attention(
            q, k, v, causal=causal, sliding_window=sliding_window,
            block_q=block_q, block_k=block_k)
    out = flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal,
                              sliding_window or None)
    return out.transpose(1, 2)


def paged_decode_attention(q, k_pages, v_pages, block_tables, lengths,
                           n_buffers: int = 2):
    """Decode attention over a slow-tier page store with a prefetch ring of
    ``n_buffers`` pages (the paper's prefetch depth P)."""
    if q.is_cuda:
        return paged_kv_gather.paged_decode_attention(
            q, k_pages, v_pages, block_tables, lengths, n_buffers=n_buffers)
    return paged_decode_attention_ref(q, k_pages, v_pages, block_tables,
                                      lengths)


def wkv6(r, k, v, log_w, u, chunk: int = 64):
    """RWKV-6 linear recurrence, chunk-streamed; ``S`` must be a multiple of
    ``min(chunk, S)``, as in the reference."""
    if r.is_cuda:
        return _wkv6.wkv6(r, k, v, log_w, u, chunk=chunk)
    _wkv6.check_chunk(r.shape[1], chunk)
    return wkv6_ref(r, k, v, log_w, u)
