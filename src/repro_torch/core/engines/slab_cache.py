"""Memcached-like engine: slab-allocated cache, chained hash + per-class LRU.

The paper's cache class, in its memcached incarnation: items are carved out
of fixed slab classes (size classes growing geometrically), each class with
its *own* LRU list, all of it -- hash chains, items, LRU links -- on
microsecond-latency memory.  A miss fetches the value from the SSD-resident
backing store and admits it, evicting the LRU tail *of the same class* (slab
allocators never evict across classes).  Compared with the CacheLib-like
two-tier engine this store has no SSD cache tier, so its IO rate is set
purely by the miss ratio -- which makes it the engine whose latency
tolerance degrades fastest as the hit rate rises, the cache-side bookend of
the paper's qualitative claim.
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as np

from ..trace_ir import US
from .base import EngineTimes, register_engine
from .trace import Recorder

__all__ = ["SlabCacheStore"]


@register_engine("slab-cache", "memcached-like")
class SlabCacheStore:
    """Chained hash table + one LRU per slab class, items on slow memory.

    get hit  = chain walk (MEM hops) + class-LRU promote (MEM hops).
    get miss = chain walk + backing-store SSD read + admit (alloc from the
               key's slab class, evicting that class's LRU tail if full).
    set      = chain walk + item write; admits on miss like a get, and
               flushes dirty evictions to the backing store in buffered
               region writes.
    """

    #: slab classes: item sizes in bytes, geometric growth factor 2
    CLASS_SIZES = (128, 256, 512, 1024)

    def __init__(
        self,
        n_keys: int,
        cache_bytes: int | None = None,    # None: items for ~12% of keys
        avg_chain: float = 1.5,
        times: EngineTimes = EngineTimes(),
        seed: int = 0,
    ):
        self.times = times
        self.n_keys = n_keys
        self.avg_chain = avg_chain
        sizes = self.CLASS_SIZES
        if cache_bytes is None:
            mean_size = sum(sizes) / len(sizes)
            cache_bytes = int(max(n_keys // 8, 8) * mean_size)
        per_class = cache_bytes // len(sizes)
        # byte budget split evenly across classes -> small classes hold more
        # items, exactly like a memcached slab rebalancer at steady state
        self.class_cap = [max(int(per_class // s), 1) for s in sizes]
        self.lru: list[OrderedDict[int, None]] = [OrderedDict() for _ in sizes]
        self.rng = np.random.default_rng(seed)
        self.gets = [0] * len(sizes)
        self.hits = [0] * len(sizes)
        self._evict_buffer = 0
        self._flush_every = 16             # buffered backing-store writes

    def _class_of(self, k: int) -> int:
        # deterministic value-size class per key (multiplicative hash)
        return (((int(k) * 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF) >> 17) % len(
            self.CLASS_SIZES
        )

    def _chain_walk(self, rec: Recorder, found: bool) -> None:
        # hash bucket head is DRAM; every chained item is a slow-memory node
        rec.cpu(self.times.t_probe)
        hops = 1 + self.rng.poisson(max(self.avg_chain - 1.0, 0.0))
        if not found:
            hops = max(hops - 1, 1)
        rec.mem(int(hops))

    def _admit(self, c: int, k: int, rec: Recorder) -> None:
        self.lru[c][k] = None
        rec.mem(2)                         # slab alloc + chain-head insert
        if len(self.lru[c]) > self.class_cap[c]:
            self.lru[c].popitem(last=False)
            rec.mem(3)                     # LRU tail unlink + chain delete
            self._evict_buffer += 1
            if self._evict_buffer >= self._flush_every:
                self._evict_buffer = 0
                rec.io(pre_extra=0.5 * US)  # flush dirty evictions (region write)

    def op(self, k: int, is_write: bool, rec: Recorder) -> None:
        t = self.times
        c = self._class_of(k)
        lru = self.lru[c]
        hit = k in lru
        if not is_write:
            self.gets[c] += 1
        if hit:
            if not is_write:
                self.hits[c] += 1
            self._chain_walk(rec, True)
            lru.move_to_end(k)
            rec.mem(3)                     # class-LRU promote
            rec.cpu(t.t_value)
        else:
            self._chain_walk(rec, False)
            if not is_write:
                rec.io()                   # backing-store read from SSD
            rec.cpu(t.t_value)
            self._admit(c, k, rec)
        rec.end_op()

    def stats(self) -> dict:
        out = {}
        total_gets = sum(self.gets)
        total_hits = sum(self.hits)
        for i, size in enumerate(self.CLASS_SIZES):
            out[f"class_{size}B"] = self.hits[i] / max(self.gets[i], 1)
        out["overall"] = total_hits / max(total_gets, 1)
        return out
