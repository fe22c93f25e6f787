"""Hash-index engine: open-addressing index on slow memory, values on SSD.

The paper's hash-index store class (memcached-style flat tables, Aerospike's
earlier hash primary index): the *index* is one large array of slots on
microsecond-latency memory, the *values* live on SSD.  Open addressing makes
the probe chain prefetch-friendly -- unlike a pointer-chased tree, the slot
addresses of a linear-probe run are known up front, so one slow-memory
prefetch covers a whole cache line of slots and only line crossings pay
another hop.  That gives this engine the lowest M (memory hops per op) of
the engine matrix and, per the paper's model, the flattest latency-tolerance
curve among the index stores.
"""
from __future__ import annotations

import numpy as np

from ..trace_ir import US
from .base import EngineTimes, register_engine
from .trace import Recorder

__all__ = ["HashIndexStore"]


@register_engine("hash-index", "open-addressing")
class HashIndexStore:
    """Open-addressing (linear probing) hash index of 16-byte slots.

    get  = bucket hash (DRAM) + probe run (one slow-memory hop per touched
           cache line of ``slots_per_line`` slots) + one SSD value read.
    put  = probe run + in-place slot update (one hop) + write-buffer append;
           a large flush IO every ``flush_block // value_size`` writes.
    """

    def __init__(
        self,
        n_keys: int,
        load_factor: float = 0.7,
        slots_per_line: int = 4,       # 64-byte line / 16-byte slot
        value_size: int = 1024,
        flush_block: int = 131072,
        times: EngineTimes | None = None,
        seed: int = 0,
    ):
        if not 0.0 < load_factor < 1.0:
            raise ValueError(f"load_factor must be in (0, 1), got {load_factor}")
        self.times = times or EngineTimes()
        self.n_keys = n_keys
        self.slots_per_line = slots_per_line
        self.flush_every = max(flush_block // value_size, 1)
        cap = 1
        while cap * load_factor < n_keys:
            cap *= 2
        self.capacity = cap
        self._mask = cap - 1
        self.slots = np.full(cap, -1, dtype=np.int64)   # key id, or -1 empty
        self._probe_total = 0
        self._probe_ops = 0
        self._pending_writes = 0
        rng = np.random.default_rng(seed)
        for k in rng.permutation(n_keys).tolist():      # untraced bulk load
            self._insert(int(k))

    def _hash(self, k: int) -> int:
        return ((int(k) * 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF) >> 32

    def _insert(self, k: int) -> None:
        i = self._hash(k) & self._mask
        while self.slots[i] >= 0:
            i = (i + 1) & self._mask
        self.slots[i] = k

    def _probe(self, k: int, rec: Recorder) -> bool:
        """Walk the probe run, recording one MEM hop per touched cache line."""
        rec.cpu(self.times.t_probe)        # bucket hash (DRAM-side compute)
        start = self._hash(k) & self._mask
        i = start
        spl = self.slots_per_line
        line = -1
        probes = 0
        found = False
        while True:
            if i // spl != line:           # crossed into a new line of slots
                line = i // spl
                rec.mem()
            s = int(self.slots[i])
            probes += 1
            if s == k:
                found = True
                break
            if s < 0:
                break
            i = (i + 1) & self._mask
        self._probe_total += probes
        self._probe_ops += 1
        return found

    def op(self, k: int, is_write: bool, rec: Recorder) -> None:
        found = self._probe(k, rec)
        if is_write:
            rec.cpu(self.times.t_value)    # serialize into the write buffer
            rec.mem()                      # in-place slot update (new value ptr)
            self._pending_writes += 1
            if self._pending_writes >= self.flush_every:
                self._pending_writes = 0
                rec.io(pre_extra=0.5 * US)  # large-block buffered flush
        elif found:
            rec.io()                       # read the value from SSD
            rec.cpu(self.times.t_value)
        rec.end_op()

    def stats(self) -> dict:
        return {
            "load_factor": self.n_keys / self.capacity,
            "avg_probes": self._probe_total / max(self._probe_ops, 1),
        }
