"""Open-addressing hash index on slow memory, values on SSD (reference).

get = bucket hash (DRAM) + probe run (one slow-memory hop per touched cache
line of ``slots_per_line`` slots) + one SSD value read; put = probe run +
in-place slot update (one hop) + write-buffer append, with a large flush IO
every ``flush_block // value_size`` writes.
"""
from __future__ import annotations

import numpy as np

from ..trace import T_PROBE, T_VALUE, US


class Store:
    def __init__(self, n_keys: int, load_factor: float = 0.7,
                 slots_per_line: int = 4, value_size: int = 1024,
                 flush_block: int = 131072, seed: int = 0):
        if not 0.0 < load_factor < 1.0:
            raise ValueError(f"load_factor must be in (0, 1): {load_factor}")
        self.n_keys = n_keys
        self.slots_per_line = slots_per_line
        self.flush_every = max(flush_block // value_size, 1)
        cap = 1
        while cap * load_factor < n_keys:
            cap *= 2
        self.capacity = cap
        self.mask = cap - 1
        self.slots = [-1] * cap
        self.probe_total = 0
        self.probe_ops = 0
        self.pending_writes = 0
        rng = np.random.default_rng(seed)
        for k in rng.permutation(n_keys).tolist():   # untraced bulk load
            i = self.hash(k) & self.mask
            while self.slots[i] >= 0:
                i = (i + 1) & self.mask
            self.slots[i] = k

    @staticmethod
    def hash(k: int) -> int:
        return ((k * 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF) >> 32

    def probe(self, k: int, rec) -> bool:
        rec.cpu(T_PROBE)
        i = self.hash(k) & self.mask
        spl = self.slots_per_line
        line = -1
        probes = 0
        while True:
            if i // spl != line:
                line = i // spl
                rec.mem()
            s = self.slots[i]
            probes += 1
            if s == k or s < 0:
                break
            i = (i + 1) & self.mask
        self.probe_total += probes
        self.probe_ops += 1
        return s == k

    def op(self, k: int, is_write: bool, rec) -> None:
        found = self.probe(k, rec)
        if is_write:
            rec.cpu(T_VALUE)
            rec.mem()
            self.pending_writes += 1
            if self.pending_writes >= self.flush_every:
                self.pending_writes = 0
                rec.io(pre_extra=0.5 * US)
        elif found:
            rec.io()
            rec.cpu(T_VALUE)
        rec.end_op()

    def stats(self) -> dict:
        return {"load_factor": self.n_keys / self.capacity,
                "avg_probes": self.probe_total / max(self.probe_ops, 1)}
