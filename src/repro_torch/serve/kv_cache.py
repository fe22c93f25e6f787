"""Tiered paged KV cache: the paper's offloaded-index/cache design for LLM
serving, in PyTorch.

Pages live in a *slow tier* page store (host DRAM / CXL-class memory on a
real deployment; a device buffer here) and are read by decode ONLY through
the prefetch pipeline (``repro_torch.kernels.ops.paged_decode_attention``).
A per-sequence block table plays the role of the KV store's index; free
pages are managed by a free list.  The prefetch depth is sized by the
paper's model via ``repro_torch.core.planner.plan_pipeline_depth``: T_mem =
per-page attention compute, E = the rest of the decode step (MLP), L_mem =
the slow-tier fetch latency -- the same Theta_prob law that governs the KV
stores governs this pipeline.  The tier's latency is an input of that model
(``TPU_HOST`` by default, as in the reference), not a property of the card.

The page payloads are two ``(L, n_pages, page, Hkv, D)`` tensors on the
store's device, written in place; the free list and the block tables are
host-side Python, as in the reference.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..core.latency_model import OpParams
from ..core.planner import plan_pipeline_depth
from ..core.sim.replay_torch import resolve_device
from ..core.tiering import MemoryTier, TPU_HOST

__all__ = ["PagedKVCache", "PageStoreConfig"]


@dataclass(frozen=True)
class PageStoreConfig:
    n_pages: int
    page_size: int = 64
    n_kv_heads: int = 8
    head_dim: int = 128
    n_layers: int = 4
    dtype: object = torch.bfloat16
    tier: MemoryTier = TPU_HOST
    device: object = None          # None means "cuda" (raises without one)


class PagedKVCache:
    """Block-table paged KV store for one model's decode path."""

    def __init__(self, cfg: PageStoreConfig):
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        shape = (cfg.n_layers, cfg.n_pages, cfg.page_size, cfg.n_kv_heads,
                 cfg.head_dim)
        self.k_pages = torch.zeros(shape, dtype=cfg.dtype, device=self.device)
        self.v_pages = torch.zeros(shape, dtype=cfg.dtype, device=self.device)
        self.free: list[int] = list(range(cfg.n_pages))[::-1]
        self.tables: dict[int, list[int]] = {}
        self.lengths: dict[int, int] = {}

    # -- index management (the "in-memory index" of the paper) -------------
    def admit(self, seq_id: int, prompt_len: int) -> bool:
        need = -(-max(prompt_len, 1) // self.cfg.page_size)
        if len(self.free) < need:
            return False
        self.tables[seq_id] = [self.free.pop() for _ in range(need)]
        self.lengths[seq_id] = prompt_len
        return True

    def extend(self, seq_id: int, n_tokens: int = 1) -> bool:
        new_len = self.lengths[seq_id] + n_tokens
        need = -(-new_len // self.cfg.page_size) - len(self.tables[seq_id])
        if need > len(self.free):
            return False
        for _ in range(need):
            self.tables[seq_id].append(self.free.pop())
        self.lengths[seq_id] = new_len
        return True

    def release(self, seq_id: int) -> None:
        self.free.extend(self.tables.pop(seq_id, []))
        self.lengths.pop(seq_id, None)

    @property
    def utilization(self) -> float:
        return 1.0 - len(self.free) / self.cfg.n_pages

    # -- page IO ------------------------------------------------------------
    def write_prompt(self, seq_id: int, k: torch.Tensor, v: torch.Tensor) -> None:
        """k, v: (L, S, Hkv, D) from prefill; scattered into this sequence's
        pages (page-aligned writes into the slow tier)."""
        L, S, Hkv, D = k.shape
        page = self.cfg.page_size
        table = self.tables[seq_id]
        pad = len(table) * page - S
        if pad:
            k = F.pad(k, (0, 0, 0, 0, 0, pad))
            v = F.pad(v, (0, 0, 0, 0, 0, pad))
        kp = k.reshape(L, len(table), page, Hkv, D)
        vp = v.reshape(L, len(table), page, Hkv, D)
        idx = torch.as_tensor(table, dtype=torch.long, device=self.device)
        self.k_pages[:, idx] = kp.to(self.k_pages.dtype)
        self.v_pages[:, idx] = vp.to(self.v_pages.dtype)

    def token_slots(self, seq_ids: list[int]):
        """(page index, slot in page) of each sequence's last position, as
        long tensors on the store's device."""
        page = self.cfg.page_size
        pos = [self.lengths[s] - 1 for s in seq_ids]
        pages = [self.tables[s][p // page] for s, p in zip(seq_ids, pos)]
        slots = [p % page for p in pos]
        return (torch.as_tensor(pages, dtype=torch.long, device=self.device),
                torch.as_tensor(slots, dtype=torch.long, device=self.device))

    def append_token(self, seq_id: int, k_t: torch.Tensor, v_t: torch.Tensor) -> None:
        """k_t, v_t: (L, Hkv, D) for the newly decoded position."""
        pos = self.lengths[seq_id] - 1
        page_idx = self.tables[seq_id][pos // self.cfg.page_size]
        slot = pos % self.cfg.page_size
        self.k_pages[:, page_idx, slot] = k_t
        self.v_pages[:, page_idx, slot] = v_t

    def batch_views(self, seq_ids: list[int], ppseq: int | None = None):
        """(block_tables (B, ppseq), lengths (B,)) padded for the kernel:
        int32 tensors on the store's device."""
        if ppseq is None:
            ppseq = max((len(self.tables[s]) for s in seq_ids), default=1)
        bt = np.zeros((len(seq_ids), ppseq), np.int32)
        ln = np.zeros((len(seq_ids),), np.int32)
        for i, s in enumerate(seq_ids):
            t = self.tables[s]
            bt[i, : len(t)] = t
            ln[i] = self.lengths[s]
        return (torch.from_numpy(bt).to(self.device),
                torch.from_numpy(ln).to(self.device))

    # -- model-driven pipeline sizing ----------------------------------------
    def plan_prefetch_depth(
        self,
        t_page_compute: float,
        t_step_other: float,
        max_depth: int = 16,
    ) -> int:
        """Size the staging-buffer count from the paper's Theta model:
        one 'operation' = one decode step of one sequence = (pages) memory
        suboperations + the rest of the step as the 'IO'."""
        avg_pages = max(
            int(np.mean([len(t) for t in self.tables.values()])) if self.tables else 1,
            1,
        )
        p = OpParams(
            M=float(avg_pages),
            T_mem=t_page_compute,
            T_io_pre=t_step_other / 2,
            T_io_post=t_step_other / 2,
            T_sw=0.0,
            P=2,
            S=1.0,
        )
        plan = plan_pipeline_depth(p, self.cfg.tier.latency, p_max=max_depth)
        return plan.prefetch_depth
