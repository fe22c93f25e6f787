"""Suboperation kinds, engine CPU-time constants, the recorder and the
trace walk: a frozen copy of the simulated store's trace layer.

A trace is three columns: ``kinds`` (one code per suboperation), ``durs``
(the CPU seconds attached to it) and ``bounds`` (op ``i`` is
``kinds[bounds[i]:bounds[i + 1]]``).  ``run_trace`` drives one engine
through a workload and records only the operations after the warm-up
fraction.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

US = 1e-6
MEM, PREIO, POSTIO, CPU = 0, 1, 2, 3

# CPU time of one suboperation of each kind (seconds).
T_MEM = 0.10 * US        # compute attached to one slow-memory hop
T_IO_PRE = 1.5 * US      # IO submission
T_IO_POST = 0.2 * US     # completion check + copy
T_PROBE = 0.05 * US      # a DRAM-side probe (hash, fence index)
T_VALUE = 0.3 * US       # value (de)serialization / checksum


@dataclass(frozen=True)
class Trace:
    kinds: np.ndarray    # int8 (n_subops,)
    durs: np.ndarray     # float64 (n_subops,)
    bounds: np.ndarray   # int64 (n_ops + 1,)

    @property
    def n_ops(self) -> int:
        return len(self.bounds) - 1

    @property
    def n_subops(self) -> int:
        return len(self.kinds)


class Recorder:
    """Collects the suboperations of the operations an engine executes."""

    def __init__(self):
        self.kinds: list[int] = []
        self.durs: list[float] = []
        self.bounds: list[int] = [0]
        self.n_mem = 0
        self.n_io = 0
        self.n_ops = 0

    def mem(self, n: int = 1) -> None:
        self.kinds.extend([MEM] * n)
        self.durs.extend([T_MEM] * n)
        self.n_mem += n

    def cpu(self, t: float) -> None:
        if t > 0.0:
            self.kinds.append(CPU)
            self.durs.append(t)

    def io(self, pre_extra: float = 0.0, post_extra: float = 0.0) -> None:
        self.kinds.append(PREIO)
        self.durs.append(T_IO_PRE + pre_extra)
        self.kinds.append(POSTIO)
        self.durs.append(T_IO_POST + post_extra)
        self.n_io += 1

    def end_op(self) -> None:
        if self.bounds[-1] == len(self.kinds):     # never an empty op
            self.kinds.append(CPU)
            self.durs.append(T_PROBE)
        self.bounds.append(len(self.kinds))
        self.n_ops += 1

    def clear(self) -> None:
        self.kinds.clear()
        self.durs.clear()
        self.bounds[:] = [0]
        self.n_ops = self.n_mem = self.n_io = 0

    def trace(self) -> Trace:
        end = self.bounds[-1]
        return Trace(np.asarray(self.kinds[:end], dtype=np.int8),
                     np.asarray(self.durs[:end], dtype=np.float64),
                     np.asarray(self.bounds, dtype=np.int64))


def run_trace(store, keys, is_write, warmup_frac: float) -> tuple[Trace, dict]:
    """Drive ``store`` through the ops ``(keys[i], is_write[i])``; return
    the trace of the ops after the first ``int(n * warmup_frac)`` and the
    store's hit statistics with the per-op averages."""
    n = len(keys)
    n_warm = int(n * warmup_frac)
    warm, rec = Recorder(), Recorder()
    for i, (k, w) in enumerate(zip(np.asarray(keys).tolist(),
                                   np.asarray(is_write).tolist())):
        store.op(int(k), bool(w), warm if i < n_warm else rec)
        if i < n_warm:
            warm.clear()
    stats = dict(store.stats())
    stats["mem_per_op"] = rec.n_mem / max(rec.n_ops, 1)
    stats["io_per_op"] = rec.n_io / max(rec.n_ops, 1)
    return rec.trace(), stats
