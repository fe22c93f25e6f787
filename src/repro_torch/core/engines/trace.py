"""Trace recording and summarization for the KV engines.

:class:`Recorder` collects the suboperations each engine emits and builds a
columnar :class:`~repro_torch.core.trace_ir.CompiledTrace` directly -- the hot
path never materializes per-op tuple lists.  :class:`TraceResult` bundles
the compiled trace with per-op averages and hit statistics, and summarizes
it into the paper's :class:`~repro_torch.core.latency_model.OpParams` so the
closed-form model can be compared against the simulated "measurement"
(Figs. 11(c)(d)(e)).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..latency_model import OpParams, US
from ..trace_ir import CPU, MEM, POSTIO, PREIO, CompiledTrace, Op
from ..workloads import Workload
from .base import EngineTimes

__all__ = ["Recorder", "TraceResult", "run_trace"]


class _OpsView(list):
    """Materialized list of completed :class:`Op` with one write-through:
    ``clear()`` also clears the recorder, preserving the pre-refactor
    ``rec.ops.clear()`` idiom (used to bound warm-up memory).  Other list
    mutations affect only this snapshot."""

    def __init__(self, recorder, items):
        super().__init__(items)
        self._recorder = recorder

    def clear(self):
        super().clear()
        self._recorder.clear()


class Recorder:
    """Collects suboperations for the current KV operation, columnar-first.

    Suboperations are appended to flat ``kinds``/``durs`` columns with an
    op-boundary array; :meth:`compile` snapshots them into an immutable
    :class:`CompiledTrace`.  The legacy ``.ops`` list-of-:class:`Op` view is
    kept for backward compatibility and is materialized on demand.
    """

    def __init__(self, times: EngineTimes):
        self.t = times
        self._kinds: list[int] = []
        self._durs: list[float] = []
        self._bounds: list[int] = [0]
        self.n_mem = 0
        self.n_io = 0
        self.n_ops = 0

    def mem(self, n: int = 1) -> None:
        self._kinds.extend([MEM] * n)
        self._durs.extend([self.t.t_mem] * n)
        self.n_mem += n

    def cpu(self, t: float) -> None:
        if t > 0.0:
            self._kinds.append(CPU)
            self._durs.append(t)

    def io(self, pre_extra: float = 0.0, post_extra: float = 0.0) -> None:
        self._kinds.append(PREIO)
        self._durs.append(self.t.t_io_pre + pre_extra)
        self._kinds.append(POSTIO)
        self._durs.append(self.t.t_io_post + post_extra)
        self.n_io += 1

    def end_op(self) -> None:
        if self._bounds[-1] == len(self._kinds):  # never emit empty ops
            self._kinds.append(CPU)
            self._durs.append(self.t.t_probe)
        self._bounds.append(len(self._kinds))
        self.n_ops += 1

    def clear(self) -> None:
        """Drop all recorded ops and counters (used to bound warm-up
        memory); afterwards per-op averages reflect only what is recorded
        next."""
        self._kinds.clear()
        self._durs.clear()
        self._bounds[:] = [0]
        self.n_ops = 0
        self.n_mem = 0
        self.n_io = 0

    def compile(self) -> CompiledTrace:
        """Snapshot the recorded *completed* operations as a columnar trace
        (suboperations of an op still in flight are excluded)."""
        end = self._bounds[-1]
        return CompiledTrace(
            np.asarray(self._kinds[:end], dtype=np.int8),
            np.asarray(self._durs[:end], dtype=np.float64),
            np.asarray(self._bounds, dtype=np.int64),
        )

    @property
    def ops(self) -> list[Op]:
        """Legacy row-oriented view of the completed operations.

        Materialized fresh per access; ``.clear()`` on it clears the
        recorder (the old idiom), other mutations only touch the snapshot.
        Prefer :meth:`compile` in new code.
        """
        if self.n_ops == 0:
            return _OpsView(self, [])
        return _OpsView(self, self.compile().to_ops())


@dataclass(init=False)
class TraceResult:
    trace: CompiledTrace          # the recorded post-warm-up operations
    mem_per_op: float             # average slow-memory hops per operation
    io_per_op: float              # average SSD accesses per operation (S)
    hit_stats: dict = field(default_factory=dict)

    def __init__(self, trace=None, mem_per_op=0.0, io_per_op=0.0,
                 hit_stats=None, ops=None):
        if trace is None:
            trace = ops               # legacy keyword: TraceResult(ops=...)
        if trace is None:
            raise TypeError("TraceResult requires 'trace' (or legacy 'ops')")
        if not isinstance(trace, CompiledTrace):
            trace = CompiledTrace.from_ops(trace)  # legacy list-of-Op form
        self.trace = trace
        self.mem_per_op = mem_per_op
        self.io_per_op = io_per_op
        self.hit_stats = {} if hit_stats is None else hit_stats

    @property
    def ops(self) -> list[Op]:
        """Legacy view: the trace as a list of :class:`Op`."""
        return self.trace.to_ops()

    def op_params(self, times: EngineTimes, P: int, T_sw: float) -> OpParams:
        """Summarize the trace into the paper's model parameters.

        Calibrated the way the paper does it (Sec. 4.2.3): T_mem / T_io_pre /
        T_io_post are the mean *CPU spans between yields* measured on the
        trace -- plain CPU suboperations (hashing, serialization) do not
        yield, so their time folds into the span of the next yield point.
        M is memory accesses per *operation*; the theta functions divide
        by S internally (Sec. 3.2.3 splitting). Ops with no IO (pure
        cache hits) contribute their hops to the average.
        """
        del times  # spans are measured from the trace, not the constants
        span_sum, span_n = self.trace.yield_spans()

        def mean(kind: int, default: float) -> float:
            return span_sum[kind] / span_n[kind] if span_n[kind] else default

        S = max(self.io_per_op, 1e-9)
        return OpParams(
            M=self.mem_per_op,
            T_mem=mean(MEM, 0.1 * US),
            T_io_pre=mean(PREIO, 1.5 * US),
            T_io_post=mean(POSTIO, 0.2 * US),
            T_sw=T_sw,
            P=P,
            S=S,
        )


def run_trace(store, wl: Workload, warmup_frac: float = 0.3) -> TraceResult:
    """Run a workload through an engine, recording only the post-warm-up ops."""
    n_warm = int(len(wl) * warmup_frac)
    warm_rec = Recorder(store.times)
    rec = Recorder(store.times)
    for i, (k, w) in enumerate(wl.pairs()):
        store.op(int(k), bool(w), warm_rec if i < n_warm else rec)
        if i < n_warm:
            warm_rec.clear()  # discard warm-up subops to bound memory
    hit_stats = store.stats() if hasattr(store, "stats") else {}
    return TraceResult(
        trace=rec.compile(),
        mem_per_op=rec.n_mem / max(rec.n_ops, 1),
        io_per_op=rec.n_io / max(rec.n_ops, 1),
        hit_stats=hit_stats,
    )
