"""Aerospike-like engine: in-memory tree index on slow memory, values on SSD."""
from __future__ import annotations

import numpy as np

from ..trace_ir import US
from .base import EngineTimes, register_engine
from .trace import Recorder

__all__ = ["TreeIndexStore"]


@register_engine("tree-index", "aerospike-like")
class TreeIndexStore:
    """Per-sprig unbalanced BSTs of 64-byte nodes (Aerospike primary index).

    get  = sprig hash (DRAM) + tree walk (slow-memory hops) + one SSD read.
    put  = tree walk + write-buffer append; a large flush IO every
           ``flush_block // value_size`` writes (Aerospike write blocks).
    """

    def __init__(
        self,
        n_keys: int,
        n_sprigs: int = 256,
        value_size: int = 1536,
        flush_block: int = 131072,
        times: EngineTimes | None = None,
        seed: int = 0,
    ):
        # Aerospike's storage path spends much more CPU per IO than raw
        # io_uring (network/defrag bookkeeping); the paper's Table 1
        # example quotes T_io_pre ~ 4 us, T_io_post ~ 3 us for this class.
        self.times = times or EngineTimes(t_io_pre=3.0 * US, t_io_post=2.0 * US)
        self.n_keys = n_keys
        self.n_sprigs = n_sprigs
        self.value_size = value_size
        self.flush_every = max(flush_block // value_size, 1)
        rng = np.random.default_rng(seed)
        order = rng.permutation(n_keys)
        # array-based BST per sprig: node i has key keys[i], children l/r
        self.sprig_of = (
            (np.arange(n_keys, dtype=np.uint64) * np.uint64(0x9E3779B97F4A7C15))
            % np.uint64(n_sprigs)
        ).astype(np.int64)
        self.root = [-1] * n_sprigs
        self.key = np.empty(n_keys, dtype=np.int64)
        self.left = np.full(n_keys, -1, dtype=np.int64)
        self.right = np.full(n_keys, -1, dtype=np.int64)
        self.node_of: dict[int, int] = {}
        self._n_nodes = 0
        for k in order.tolist():
            self._insert(int(k))
        self._pending_writes = 0

    def _insert(self, k: int) -> int:
        """Untraced build-time insert; returns hop count."""
        i = self._n_nodes
        self.key[i] = k
        self.node_of[k] = i
        self._n_nodes += 1
        s = int(self.sprig_of[k])
        cur = self.root[s]
        hops = 0
        if cur < 0:
            self.root[s] = i
            return 0
        while True:
            hops += 1
            if k < self.key[cur]:
                if self.left[cur] < 0:
                    self.left[cur] = i
                    return hops
                cur = self.left[cur]
            else:
                if self.right[cur] < 0:
                    self.right[cur] = i
                    return hops
                cur = self.right[cur]

    def _sprig(self, k: int) -> int:
        # python ints: intentional 64-bit multiplicative hash without
        # numpy's overflow warning
        return ((int(k) * 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF) % self.n_sprigs

    def _walk(self, k: int, rec: Recorder) -> bool:
        rec.cpu(self.times.t_probe)  # sprig hash + root lookup (DRAM)
        cur = self.root[self._sprig(k)]
        while cur >= 0:
            rec.mem()  # node is a 64-byte record on slow memory
            if k == self.key[cur]:
                return True
            cur = self.left[cur] if k < self.key[cur] else self.right[cur]
        return False

    def op(self, k: int, is_write: bool, rec: Recorder) -> None:
        found = self._walk(k, rec)
        if is_write:
            rec.cpu(self.times.t_value)       # serialize into write buffer
            rec.mem()                          # update index entry in place
            self._pending_writes += 1
            if self._pending_writes >= self.flush_every:
                self._pending_writes = 0
                rec.io(pre_extra=0.5 * US)     # large-block flush write
        elif found:
            rec.io()                           # read value from SSD
            rec.cpu(self.times.t_value)
        rec.end_op()

    def stats(self) -> dict:
        return {}
