"""Continuous-batching serving engine over the tiered paged KV cache, in
PyTorch.

Requests are admitted into decode slots as pages allow; each engine step
decodes one token for every active sequence with the paged-attention
prefetch pipeline; finished sequences release their pages.  The scheduler
overlaps, in the paper's terms, the "memory suboperations" (page fetches
of step t+1's attention) with the "IO" (the dense compute of step t) --
Observation O2 is why a deep slow tier does not stall decode.

The engine runs on the card unless the caller asks for the CPU
(``device=None`` means ``"cuda"`` and raises without one).  On the card the
per-layer decode attention is the hand-written CUDA kernel
(``repro_torch.kernels.csrc.paged_kv_gather``); on the CPU its plain version.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..core.sim.replay_torch import resolve_device
from ..kernels.ops import paged_decode_attention
from ..models import transformer as tf
from ..models.layers import embed, init_params
from .kv_cache import PagedKVCache, PageStoreConfig

__all__ = ["Request", "ServeEngine"]


@dataclass
class Request:
    rid: int
    prompt: np.ndarray               # (S,) int32
    max_new_tokens: int = 16
    out_tokens: list[int] = field(default_factory=list)
    done: bool = False


class ServeEngine:
    """Minimal but real: prefill -> paged decode -> sample -> continue.

    ``stats`` accumulates host seconds and counts of the two phases:
    ``prefill_s`` / ``prefill_tokens`` (admission: prefill and the first
    token) and ``decode_s`` / ``decode_steps`` / ``decode_tokens``.  Each
    phase ends by copying sampled tokens to the host, so its seconds include
    the device work.  ``last_decode`` is ``(seq_ids, logits)`` of the latest
    decode step.
    """

    def __init__(self, cfg, params=None, *, n_pages: int = 256,
                 page_size: int = 16, max_slots: int = 8, seed: int = 0,
                 greedy: bool = True, device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = init_params(tf.param_specs(cfg), gen)
        if params["embed"].device != self.device:
            raise ValueError(f"params are on {params['embed'].device}, the "
                             f"engine on {self.device}")
        self.params = params
        self._layers = [tf.layer_params(params, li)
                        for li in range(cfg.n_layers)]
        self.cache = PagedKVCache(PageStoreConfig(
            n_pages=n_pages, page_size=page_size, n_kv_heads=cfg.n_kv_heads,
            head_dim=cfg.head_dim, n_layers=cfg.n_layers, device=self.device,
        ))
        self.max_slots = max_slots
        self.greedy = greedy
        self.active: dict[int, Request] = {}
        self.waiting: list[Request] = []
        self.gen = torch.Generator(device=self.device).manual_seed(seed + 1)
        self.steps = 0
        self.stats = {"prefill_s": 0.0, "prefill_tokens": 0, "decode_s": 0.0,
                      "decode_steps": 0, "decode_tokens": 0}
        self.last_decode = None

    # ------------------------------------------------------------------ API
    def submit(self, req: Request) -> None:
        self.waiting.append(req)

    def run(self, max_steps: int = 1000) -> list[Request]:
        finished = []
        while (self.waiting or self.active) and self.steps < max_steps:
            finished.extend(self.step())
        return finished

    # ----------------------------------------------------------------- core
    @torch.no_grad()
    def _admit(self) -> None:
        while self.waiting and len(self.active) < self.max_slots:
            req = self.waiting[0]
            if not self.cache.admit(req.rid, len(req.prompt)):
                break
            self.waiting.pop(0)
            t0 = time.perf_counter()
            tokens = torch.as_tensor(np.asarray(req.prompt),
                                     device=self.device)[None]
            logits, cache = tf.prefill(self.params, tokens, self.cfg)
            # cache["k"]: (L, 1, W, Hkv, D) -> per-layer (L, S, Hkv, D)
            S = len(req.prompt)
            self.cache.write_prompt(req.rid, cache["k"][:, 0, :S],
                                    cache["v"][:, 0, :S])
            tok = self._sample(logits[:, -1])[0]
            self.stats["prefill_s"] += time.perf_counter() - t0
            self.stats["prefill_tokens"] += S
            req.out_tokens.append(int(tok))
            self.active[req.rid] = req

    def _sample(self, logits: torch.Tensor) -> np.ndarray:
        if self.greedy:
            return torch.argmax(logits, dim=-1).cpu().numpy().reshape(-1)
        probs = torch.softmax(logits.float(), dim=-1)
        return torch.multinomial(probs, 1, generator=self.gen).cpu().numpy().reshape(-1)

    @torch.no_grad()
    def _decode_active(self) -> torch.Tensor:
        """One token for every active sequence via the paged kernel."""
        cfg = self.cfg
        seq_ids = sorted(self.active)
        tokens = torch.as_tensor(
            [[self.active[s].out_tokens[-1]] for s in seq_ids],
            dtype=torch.long, device=self.device)
        for s in seq_ids:
            self.cache.extend(s, 1)
        bt, lengths = self.cache.batch_views(seq_ids)
        page_idx, slot = self.cache.token_slots(seq_ids)
        B = len(seq_ids)
        x = embed(self.params, tokens)                         # (B,1,d)
        positions = (lengths - 1)[:, None]                     # new slot index
        for li, lw in enumerate(self._layers):
            h = tf._norm(x, None, cfg, "attn_norm", "attn_norm_b", lw)
            q, k, v = tf._qkv(h, lw, cfg, positions)
            # write the new token's KV into its page slot, then attend over
            # the page store through the prefetch kernel.
            self._write_token_layer(li, page_idx, slot, k[:, 0], v[:, 0])
            o = paged_decode_attention(
                q[:, 0], self.cache.k_pages[li], self.cache.v_pages[li],
                bt, lengths,
            )
            x = x + (o.reshape(B, -1) @ lw["wo"])[:, None]
            x = tf._ffn(x, lw, cfg)
        return tf._head(self.params, x, cfg)[:, 0]

    def _write_token_layer(self, li, page_idx, slot, k_t, v_t) -> None:
        """All active sequences' new K/V of layer ``li`` in one scatter (the
        reference writes them one sequence at a time; the bytes written are
        the same)."""
        self.cache.k_pages[li].index_put_((page_idx, slot), k_t)
        self.cache.v_pages[li].index_put_((page_idx, slot), v_t)

    def step(self) -> list[Request]:
        self._admit()
        finished: list[Request] = []
        if self.active:
            t0 = time.perf_counter()
            seq_ids = sorted(self.active)
            logits = self._decode_active()
            toks = self._sample(logits)
            self.stats["decode_s"] += time.perf_counter() - t0
            self.stats["decode_steps"] += 1
            self.stats["decode_tokens"] += len(seq_ids)
            self.last_decode = (seq_ids, logits)
            for tok, s in zip(toks, seq_ids):
                req = self.active[s]
                req.out_tokens.append(int(tok))
                if len(req.out_tokens) >= req.max_new_tokens:
                    req.done = True
                    finished.append(req)
                    self.cache.release(s)
                    del self.active[s]
        self.steps += 1
        return finished
