"""RocksDB-like store: one sorted run in data blocks on SSD, an LRU block
cache on slow memory; fence index and memtable in DRAM (reference)."""
from __future__ import annotations

import math
from collections import OrderedDict

from ..trace import T_PROBE, T_VALUE, US


class Store:
    def __init__(self, n_keys: int, entries_per_block: int = 10,
                 cache_blocks: int | None = None, restart_interval: int = 16,
                 memtable_ops: int = 4096):
        self.epb = entries_per_block
        n_blocks = (n_keys + entries_per_block - 1) // entries_per_block
        self.cache_cap = (max(n_blocks // 12, 1) if cache_blocks is None
                          else cache_blocks)
        self.restart = restart_interval
        self.memtable_ops = memtable_ops
        self.cache: OrderedDict = OrderedDict()
        self.mem_writes = 0
        self.hits = 0
        self.lookups = 0

    def op(self, k: int, is_write: bool, rec) -> None:
        if is_write:
            rec.cpu(T_PROBE + T_VALUE)              # memtable insert
            self.mem_writes += 1
            if self.mem_writes >= self.memtable_ops:
                self.mem_writes = 0
                rec.io(pre_extra=1.0 * US)          # flush
                rec.io(pre_extra=1.0 * US)          # compaction read + write
                rec.cpu(20.0 * US)
            rec.end_op()
            return
        rec.cpu(T_PROBE)                            # memtable probe
        rec.cpu(T_PROBE)                            # fence index search
        block = k // self.epb
        self.lookups += 1
        rec.mem()                                   # cache bucket probe
        if block in self.cache:
            self.hits += 1
            self.cache.move_to_end(block)
            rec.mem(2)                              # LRU relink
        else:
            rec.io()                                # read the data block
            rec.cpu(T_VALUE)                        # checksum + decode
            self.cache[block] = None
            rec.mem(2)                              # insert: hash + LRU head
            if len(self.cache) > self.cache_cap:
                self.cache.popitem(last=False)
                rec.mem(2)                          # evict the tail
        n_restarts = max(self.epb // self.restart, 1)
        hops = max(int(math.ceil(math.log2(n_restarts + 1))), 1)
        hops += min(self.restart, self.epb) // 4
        rec.mem(hops)                               # search inside the block
        rec.cpu(T_VALUE)
        rec.end_op()

    def stats(self) -> dict:
        return {"block_cache": self.hits / max(self.lookups, 1)}
