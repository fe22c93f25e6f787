"""RocksDB-like engine: LSM data blocks on SSD, block cache on slow memory."""
from __future__ import annotations

import math
from collections import OrderedDict

from .base import EngineTimes, register_engine
from .trace import Recorder
from ..trace_ir import US

__all__ = ["LSMStore"]


@register_engine("lsm", "rocksdb-like")
class LSMStore:
    """Single sorted run partitioned into data blocks + LRU block cache.

    Fence index and memtable stay in DRAM (the paper offloads only the 32-GB
    block cache, 80% of footprint). A block-cache probe costs hash + LRU
    hops on slow memory; a hit binary-searches the block's restart points
    (slow memory); a miss reads the 4-kB block from SSD and installs it.
    """

    def __init__(
        self,
        n_keys: int,
        entries_per_block: int = 10,       # ~4 kB / 400-B values
        cache_blocks: int | None = None,   # None: sized for ~67% hit @ Zipf .99
        restart_interval: int = 16,
        memtable_ops: int = 4096,
        times: EngineTimes = EngineTimes(),
    ):
        self.times = times
        self.n_keys = n_keys
        self.epb = entries_per_block
        self.n_blocks = (n_keys + entries_per_block - 1) // entries_per_block
        if cache_blocks is None:
            cache_blocks = max(self.n_blocks // 12, 1)
        self.cache_cap = cache_blocks
        self.restart = restart_interval
        self.memtable_ops = memtable_ops
        # LRU block cache: block_id -> tick; plus an eviction clock.
        self.cache: "OrderedDict[int, None]" = OrderedDict()
        self._mem_writes = 0
        self.hits = 0
        self.lookups = 0

    def _search_block(self, rec: Recorder) -> None:
        # binary search over restart points, then linear scan inside one
        # restart interval; every probed key is a slow-memory access.
        n_restarts = max(self.epb // self.restart, 1)
        hops = max(int(math.ceil(math.log2(n_restarts + 1))), 1)
        hops += min(self.restart, self.epb) // 4  # expected linear-scan touches
        rec.mem(hops)

    def op(self, k: int, is_write: bool, rec: Recorder) -> None:
        t = self.times
        if is_write:
            rec.cpu(t.t_probe + t.t_value)     # memtable insert (DRAM skiplist)
            self._mem_writes += 1
            if self._mem_writes >= self.memtable_ops:
                self._mem_writes = 0
                # flush: one large sequential write + compaction read+write
                rec.io(pre_extra=1.0 * US)
                rec.io(pre_extra=1.0 * US)
                rec.cpu(20.0 * US)             # compaction merge CPU burst
            rec.end_op()
            return
        rec.cpu(t.t_probe)                     # memtable probe (DRAM)
        rec.cpu(t.t_probe)                     # fence-index binary search (DRAM)
        block = int(k) // self.epb
        self.lookups += 1
        rec.mem()                              # cache hash-bucket probe
        if block in self.cache:
            self.hits += 1
            self.cache.move_to_end(block)
            rec.mem(2)                         # LRU unlink/relink touches
        else:
            rec.io()                           # read 4-kB data block
            rec.cpu(t.t_value)                 # checksum + decode
            self.cache[block] = None
            rec.mem(2)                         # insert into hash + LRU head
            if len(self.cache) > self.cache_cap:
                self.cache.popitem(last=False)
                rec.mem(2)                     # evict tail: unlink + hash del
        self._search_block(rec)
        rec.cpu(t.t_value)
        rec.end_op()

    @property
    def hit_ratio(self) -> float:
        return self.hits / max(self.lookups, 1)

    def stats(self) -> dict:
        return {"block_cache": self.hit_ratio}
