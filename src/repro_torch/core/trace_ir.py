"""Columnar trace IR shared by the KV engines and the simulator.

A *trace* is a sequence of KV operations, each a run of suboperations in
the paper's Sec. 3 operation model:

  * ``MEM``    -- a pointer dereference on slow memory (prefetch + yield);
                  the duration is the CPU compute attached to the hop (T_mem)
  * ``PREIO``  -- asynchronous IO submission (T_io_pre), parks the thread
  * ``POSTIO`` -- IO completion check + copy (T_io_post)
  * ``CPU``    -- plain compute (hashing, serialization); never yields

Two representations exist:

  * :class:`Op` -- one operation as a tuple of ``(kind, duration)`` pairs.
    The original row-oriented form; kept for ad-hoc construction and
    backward compatibility.
  * :class:`CompiledTrace` -- the whole trace as three numpy columns
    (``kinds``, ``durs``, ``bounds``).  This is the hot-path format: built
    once by :class:`repro_torch.core.engines.trace.Recorder`, summarized
    vectorized by ``TraceResult.op_params``, shipped cheaply to worker
    processes, and replayed by the simulator's compiled fast loop without
    per-op tuple churn.

The columnar layout
-------------------
All suboperations of all operations are concatenated into two parallel flat
arrays plus one offset array marking where each operation starts::

    kinds  : int8[n_subops]     -- MEM/PREIO/POSTIO/CPU code per suboperation
    durs   : float64[n_subops]  -- CPU seconds attached to that suboperation
    bounds : int64[n_ops + 1]   -- bounds[i]:bounds[i+1] slices out op i

For example, a get that chases two index pointers and reads one value from
SSD, followed by a pure-cache-hit get, is::

    kinds  = [MEM, MEM, PREIO, POSTIO, CPU,   MEM, MEM]
    durs   = [0.1u, 0.1u, 1.5u, 0.2u, 0.3u,   0.1u, 0.1u]
    bounds = [0,                          5,            7]

``bounds[0] == 0``, ``bounds[-1] == n_subops``, and empty operations are
disallowed -- every index in ``kinds`` belongs to exactly one op, so the
replay loop needs no sentinel checks.  Note that ``durs`` never stores a
*memory or IO latency*: those are device properties sampled at simulation
time (the same trace is replayed at every point of a latency sweep); a MEM
duration is only the CPU compute attached to the hop.

This module deliberately has no dependency on either the engines or the
simulator packages -- it is the neutral layer both import.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Sequence

import numpy as np

US = 1e-6

# Suboperation kinds (stable on-disk/in-array encoding).
MEM, PREIO, POSTIO, CPU = 0, 1, 2, 3

KIND_NAMES = {MEM: "MEM", PREIO: "PREIO", POSTIO: "POSTIO", CPU: "CPU"}

__all__ = [
    "US",
    "MEM",
    "PREIO",
    "POSTIO",
    "CPU",
    "KIND_NAMES",
    "Op",
    "CompiledTrace",
    "compile_ops",
]


@dataclass(frozen=True)
class Op:
    """One KV operation: a flat tuple of (kind, duration) suboperations.

    ``duration`` of a MEM subop is its CPU compute time (T_mem); PREIO /
    POSTIO carry their CPU times; CPU is plain compute with no memory or IO
    semantics (used by the KV engines for hashing/serialization work).
    """

    subops: tuple[tuple[int, float], ...]


class CompiledTrace:
    """A whole trace in columnar form: ``kinds``/``durs`` + op ``bounds``.

    Construct via :meth:`from_ops`, :meth:`from_columns`, or let a
    ``Recorder`` emit one.  Instances are immutable by convention (the
    arrays are flagged non-writeable) so they can be shared freely across
    sweep points and worker processes.
    """

    __slots__ = ("kinds", "durs", "bounds", "_lists")

    def __init__(self, kinds: np.ndarray, durs: np.ndarray, bounds: np.ndarray):
        kinds = np.ascontiguousarray(kinds, dtype=np.int8)
        durs = np.ascontiguousarray(durs, dtype=np.float64)
        bounds = np.ascontiguousarray(bounds, dtype=np.int64)
        if bounds.ndim != 1 or len(bounds) < 2:
            raise ValueError("bounds must hold n_ops + 1 >= 2 offsets")
        if bounds[0] != 0 or bounds[-1] != len(kinds) or len(kinds) != len(durs):
            raise ValueError("inconsistent columnar trace shape")
        if np.any(np.diff(bounds) <= 0):
            raise ValueError("empty ops are not allowed in a compiled trace")
        for a in (kinds, durs, bounds):
            a.setflags(write=False)
        self.kinds = kinds
        self.durs = durs
        self.bounds = bounds
        self._lists: tuple | None = None

    # The columns cross process boundaries (sweep workers); the derived
    # list cache is dropped and rebuilt on the far side.
    def __getstate__(self):
        return (self.kinds, self.durs, self.bounds)

    def __setstate__(self, state):
        kinds, durs, bounds = state
        for a in (kinds, durs, bounds):
            a.setflags(write=False)
        self.kinds = kinds
        self.durs = durs
        self.bounds = bounds
        self._lists = None

    # -- construction -----------------------------------------------------

    @classmethod
    def from_ops(cls, ops: Sequence[Op]) -> "CompiledTrace":
        """Compile a row-oriented list of :class:`Op` (the legacy format)."""
        kinds: list[int] = []
        durs: list[float] = []
        bounds = [0]
        for op in ops:
            for k, d in op.subops:
                kinds.append(k)
                durs.append(d)
            bounds.append(len(kinds))
        return cls(np.asarray(kinds, dtype=np.int8),
                   np.asarray(durs, dtype=np.float64),
                   np.asarray(bounds, dtype=np.int64))

    @classmethod
    def from_columns(cls, kinds, durs, bounds) -> "CompiledTrace":
        return cls(np.asarray(kinds), np.asarray(durs), np.asarray(bounds))

    @classmethod
    def single_op(cls, op: Op) -> "CompiledTrace":
        """A one-op trace (e.g. the microbenchmark's fixed pointer chase)."""
        return cls.from_ops([op])

    # -- views ------------------------------------------------------------

    @property
    def n_ops(self) -> int:
        return len(self.bounds) - 1

    @property
    def n_subops(self) -> int:
        return len(self.kinds)

    def __len__(self) -> int:
        return self.n_ops

    def op(self, i: int) -> Op:
        s, e = int(self.bounds[i]), int(self.bounds[i + 1])
        return Op(tuple(zip(self.kinds[s:e].tolist(), self.durs[s:e].tolist())))

    def to_ops(self) -> list[Op]:
        """Materialize the legacy row-oriented form (back-compat paths)."""
        kinds = self.kinds.tolist()
        durs = self.durs.tolist()
        bounds = self.bounds.tolist()
        return [
            Op(tuple(zip(kinds[s:e], durs[s:e])))
            for s, e in zip(bounds, bounds[1:])
        ]

    def as_lists(self) -> tuple[list[int], list[float], list[int], list[int]]:
        """(kinds, durs, op_starts, op_ends) as plain Python lists.

        The simulator's compiled loop indexes these in its inner loop --
        plain lists are ~3x faster than numpy scalar indexing there.  The
        conversion is done once and cached on the instance (and therefore
        once per worker process after a fork).
        """
        if self._lists is None:
            bounds = self.bounds.tolist()
            self._lists = (
                self.kinds.tolist(),
                self.durs.tolist(),
                bounds[:-1],
                bounds[1:],
            )
        return self._lists

    # -- summaries --------------------------------------------------------

    def counts(self) -> dict[str, int]:
        out = {}
        for kind, name in KIND_NAMES.items():
            out[name] = int(np.count_nonzero(self.kinds == kind))
        return out

    def mean_per_op(self, kind: int) -> float:
        return float(np.count_nonzero(self.kinds == kind)) / max(self.n_ops, 1)

    def yield_spans(self) -> tuple[dict[int, float], dict[int, int]]:
        """Mean CPU span between yields per yield kind, vectorized.

        Implements the paper's Sec. 4.2.3 calibration: plain CPU subops do
        not yield, so their time folds into the span of the *next* yield
        point; CPU time trailing the last yield folds backward into it.
        Returns (span_sum, span_n) keyed by MEM/PREIO/POSTIO.
        """
        kinds = self.kinds
        durs = self.durs
        is_cpu = kinds == CPU
        cpu_cum = np.cumsum(np.where(is_cpu, durs, 0.0))
        yield_idx = np.flatnonzero(~is_cpu)
        span_sum = {MEM: 0.0, PREIO: 0.0, POSTIO: 0.0}
        span_n = {MEM: 0, PREIO: 0, POSTIO: 0}
        if len(yield_idx) == 0:
            return span_sum, span_n
        # CPU accumulated strictly before each yield, minus what was already
        # attributed to the previous yield.
        cpu_before = cpu_cum[yield_idx]  # kinds[yield_idx] != CPU, so this
        # equals the cumulative CPU up to (not including) the yield.
        prev = np.concatenate(([0.0], cpu_before[:-1]))
        spans = durs[yield_idx] + (cpu_before - prev)
        ykinds = kinds[yield_idx]
        for kind in (MEM, PREIO, POSTIO):
            mask = ykinds == kind
            span_sum[kind] = float(spans[mask].sum())
            span_n[kind] = int(np.count_nonzero(mask))
        trailing = float(cpu_cum[-1] - cpu_before[-1])
        if trailing > 0.0:
            span_sum[int(ykinds[-1])] += trailing
        return span_sum, span_n

    # -- interop with the generic simulator ------------------------------

    def as_source(self) -> Callable:
        """A ``trace_source``-compatible callable over this trace.

        Byte-for-byte equivalent to ``trace_source(self.to_ops())`` --
        including the quirk that one ``rng.randrange`` is drawn per fetch
        (the legacy closure evaluates it as a ``setdefault`` argument), so
        generic-loop results are bit-identical either way.
        """
        ops = self.to_ops()
        n = len(ops)

        def src(rng, _state={}):
            i = _state.setdefault("i", rng.randrange(n))
            _state["i"] = (i + 1) % n
            return ops[i]

        return src

    def __repr__(self) -> str:
        return (f"CompiledTrace(n_ops={self.n_ops}, n_subops={self.n_subops}, "
                f"counts={self.counts()})")


def compile_ops(ops: Sequence[Op]) -> CompiledTrace:
    """Functional alias for :meth:`CompiledTrace.from_ops`."""
    return CompiledTrace.from_ops(ops)
