"""CacheLib-like engine: two-tier cache, chained items + LRU on slow memory."""
from __future__ import annotations

from collections import OrderedDict

import numpy as np

from ..trace_ir import US
from .base import EngineTimes, register_engine
from .trace import Recorder

__all__ = ["TwoTierCacheStore"]


@register_engine("two-tier-cache", "cachelib-like")
class TwoTierCacheStore:
    """Tier-1: DRAM hash buckets -> item chains + LRU list on slow memory.
    Tier-2: SSD small-object cache. Misses fetch from the backing store
    (CPU-modelled) and admit into tier 1, evicting to tier 2.
    """

    def __init__(
        self,
        n_keys: int,
        tier1_items: int | None = None,    # None: ~8% of keys (8 GB / 100 M)
        tier2_items: int | None = None,    # None: ~32% of keys
        avg_chain: float = 1.5,
        times: EngineTimes = EngineTimes(),
        seed: int = 0,
    ):
        self.times = times
        self.n_keys = n_keys
        self.t1_cap = tier1_items if tier1_items is not None else max(n_keys // 12, 1)
        self.t2_cap = tier2_items if tier2_items is not None else max(n_keys // 3, 1)
        self.avg_chain = avg_chain
        self.t1: "OrderedDict[int, None]" = OrderedDict()
        self.t2: "OrderedDict[int, None]" = OrderedDict()
        self.rng = np.random.default_rng(seed)
        self.t1_hits = 0
        self.t2_hits = 0
        self.t2_lookups = 0
        self.gets = 0
        self._evict_buffer = 0
        self._flush_every = 16                 # buffered tier-2 region writes

    def _chain_walk(self, rec: Recorder, found: bool) -> None:
        # hash bucket is DRAM; each chained item is a slow-memory node
        rec.cpu(self.times.t_probe)
        hops = 1 + self.rng.poisson(max(self.avg_chain - 1.0, 0.0))
        if not found:
            hops = max(hops - 1, 1)
        rec.mem(int(hops))

    def _admit(self, k: int, rec: Recorder) -> None:
        self.t1[k] = None
        rec.mem(2)                             # alloc item + chain-head insert
        if len(self.t1) > self.t1_cap:
            victim, _ = self.t1.popitem(last=False)
            rec.mem(3)                         # LRU tail unlink + chain del
            self.t2[victim] = None
            self._evict_buffer += 1
            if self._evict_buffer >= self._flush_every:
                self._evict_buffer = 0
                rec.io(pre_extra=0.5 * US)     # flush a tier-2 region write
            if len(self.t2) > self.t2_cap:
                self.t2.popitem(last=False)

    def op(self, k: int, is_write: bool, rec: Recorder) -> None:
        t = self.times
        if is_write:
            if k in self.t1:
                self._chain_walk(rec, True)
                self.t1.move_to_end(k)
                rec.mem(3)                     # LRU promote
                rec.cpu(t.t_value)
            else:
                self._chain_walk(rec, False)
                rec.cpu(t.t_value)
                self._admit(k, rec)
            rec.end_op()
            return
        self.gets += 1
        if k in self.t1:
            self.t1_hits += 1
            self._chain_walk(rec, True)
            self.t1.move_to_end(k)
            rec.mem(3)                         # LRU promote
            rec.cpu(t.t_value)
            rec.end_op()
            return
        self._chain_walk(rec, False)
        self.t2_lookups += 1
        rec.io()                               # tier-2 SOC bucket read
        if k in self.t2:
            self.t2_hits += 1
            self.t2.move_to_end(k)
            rec.cpu(t.t_value)
        else:
            rec.cpu(2.0 * US)                  # backing-store fetch + build
        self._admit(k, rec)
        rec.end_op()

    @property
    def hit_stats(self) -> dict:
        t1 = self.t1_hits / max(self.gets, 1)
        t2 = self.t2_hits / max(self.t2_lookups, 1)
        return {"tier1": t1, "tier2": t2, "overall": t1 + (1 - t1) * t2}

    def stats(self) -> dict:
        return self.hit_stats
