"""Batched latency sweeps: the paper's measurement protocol as one fast call.

The headline artifact of the paper (Figs. 9-11) is throughput vs. memory
latency with the thread count re-optimized at every latency point.  The
legacy way to produce it was a Python loop calling ``best_over_threads``
per point over a row-oriented tuple trace -- re-paying interpreter overhead
for every cell of the latency x threads grid.

:func:`sweep_latency` runs the whole grid through the compiled fast loop
(:func:`~repro_torch.core.sim.engine_loop.simulate_compiled`) against **one**
shared :class:`~repro_torch.core.trace_ir.CompiledTrace`, optionally fans the
cells out over worker processes (fork start method; the trace is inherited,
never pickled per task), and can memoize finished cells in a small on-disk
cache so repeated benchmark runs are incremental.

Each grid cell is seeded exactly like the legacy protocol
(``replace(cfg, L_mem=L, n_threads=n)`` with the same ``cfg.seed``), so
per-point throughput matches the legacy event loop; see
``tests/test_sweep.py`` for the equivalence guarantees.
"""
from __future__ import annotations

import hashlib
import json
import multiprocessing as mp
import numbers
import os
import re
import sys
import time
from dataclasses import dataclass, replace
from typing import Callable, Iterable, Sequence

from ..trace_ir import CompiledTrace, Op
from .arrivals import ArrivalSpec, LatencySummary, generate_arrivals
from .config import DEFAULT_THREAD_CANDIDATES, SimConfig, SimResult
from .engine_loop import simulate, simulate_compiled

__all__ = ["SweepPoint", "sweep_latency", "clear_sweep_cache",
           "prune_sweep_cache", "BACKENDS"]

#: Valid ``backend=`` values: the vectorized device grid
#: (:mod:`.replay_torch`, the default), or the host interpreter loops
#: (generic/compiled).
BACKENDS = ("torch", "loop")


@dataclass
class SweepPoint:
    """Best operating point at one memory latency."""

    L_mem: float | Sequence[tuple[float, float]]
    n_threads: int                 # best thread count at this latency
    result: SimResult              # the winning simulation
    per_thread: dict[int, float]   # throughput of every candidate

    @property
    def throughput(self) -> float:
        return self.result.throughput


def _coerce_trace(source) -> tuple[CompiledTrace | None, Callable | None]:
    """Accept CompiledTrace / TraceResult / list[Op] / legacy callable."""
    if isinstance(source, CompiledTrace):
        return source, None
    trace = getattr(source, "trace", None)   # TraceResult duck-type
    if isinstance(trace, CompiledTrace):
        return trace, None
    if isinstance(source, (list, tuple)):
        if not source:
            raise ValueError("cannot sweep an empty op list")
        if isinstance(source[0], Op):
            return CompiledTrace.from_ops(source), None
    if callable(source):
        return None, source
    raise TypeError(
        "source must be a CompiledTrace, TraceResult, list[Op], or an "
        f"op-source callable, not {type(source).__name__}"
    )


def _run_cell(cfg: SimConfig, trace, src_fn, n_ops: int,
              warmup_ops: int | None,
              collect_latency: bool = False,
              arrivals=None, collect_percentiles: bool = False,
              deadline: float = 0.0) -> SimResult:
    kw = dict(arrivals=arrivals, collect_percentiles=collect_percentiles,
              deadline=deadline)
    if trace is not None:
        return simulate_compiled(cfg, trace, n_ops, warmup_ops,
                                 collect_latency, **kw)
    return simulate(cfg, src_fn, n_ops, warmup_ops, collect_latency, **kw)


# -- worker-process plumbing -------------------------------------------------

_WORKER_STATE: dict = {}


def _worker_init(trace, src_fn, n_ops, warmup_ops, collect_latency,
                 arrivals=None, collect_percentiles=False, deadline=0.0):
    _WORKER_STATE["args"] = (trace, src_fn, n_ops, warmup_ops,
                             collect_latency, arrivals,
                             collect_percentiles, deadline)
    if trace is not None:
        trace.as_lists()   # pay the one-time columnar->list cost per worker


def _worker_run(cfg: SimConfig) -> SimResult:
    return _run_cell(cfg, *_WORKER_STATE["args"])


def _cuda_initialized() -> bool:
    """Whether this process holds a CUDA context (without importing torch
    just to ask: a process that never imported it holds none)."""
    torch = sys.modules.get("torch")
    return torch is not None and torch.cuda.is_initialized()


def _pick_context(trace, src_fn):
    """Choose a start method that is both fast and fork-safe.

    * ``fork`` is the fast path: the trace (or a stateless source callable)
      is inherited by the workers, nothing is pickled per task.  A forked
      child cannot use a CUDA context its parent initialized, so it is
      used only while CUDA is not initialized in this process.
    * ``forkserver`` sidesteps that (workers fork from a clean server
      process) at the cost of pickling the initargs, so it needs a
      picklable trace; the server preloads this module so workers do not
      re-import numpy/repro_torch per pool.
    * Otherwise: run serial.
    """
    methods = mp.get_all_start_methods()
    if "fork" in methods and not _cuda_initialized():
        return mp.get_context("fork")
    if "forkserver" in methods and trace is not None and src_fn is None:
        ctx = mp.get_context("forkserver")
        try:
            ctx.set_forkserver_preload(["repro_torch.core.sim.sweep"])
        except Exception:  # pragma: no cover - preload is best-effort
            pass
        return ctx
    return None


def _run_torch_cells(cfg: SimConfig, trace: CompiledTrace, latencies,
                     candidates, n_ops, warmup_ops, results, todo,
                     grid_opts=None, arrivals=None,
                     collect_percentiles=False, deadline=0.0) -> None:
    """Fill ``results[i]`` for every grid index in ``todo`` via the torch
    backend.  All missing scalar-latency cells run as one vectorized grid
    call (:func:`repro_torch.core.sim.replay_torch.sweep_grid`);
    mixture-latency cells (which the grid does not model) run through the
    compiled loop per cell.  ``grid_opts`` are extra ``sweep_grid`` kwargs
    (``device``/``use_kernel``/``substeps``) -- they select execution
    strategy, never values."""
    from . import replay_torch   # deferred: torch is a heavyweight import

    k = len(candidates)
    # numbers.Real admits numpy scalars too (np.float32 is not a float
    # subclass), keeping this classification consistent with sweep_grid's
    need_lis = sorted({
        i // k for i in todo
        if isinstance(latencies[i // k], numbers.Real)
    })
    grid = None
    if need_lis:
        grid = replay_torch.sweep_grid(
            cfg, trace, [latencies[li] for li in need_lis], candidates,
            n_ops, warmup_ops, arrivals=arrivals,
            collect_percentiles=collect_percentiles, deadline=deadline,
            **(grid_opts or {}))
    row_of = {li: r for r, li in enumerate(need_lis)}
    for i in todo:
        li, ci = divmod(i, k)
        if li in row_of:
            results[i] = grid.result(row_of[li], ci)
        else:
            results[i] = simulate_compiled(
                replace(cfg, L_mem=latencies[li], n_threads=candidates[ci]),
                trace, n_ops, warmup_ops, arrivals=arrivals,
                collect_percentiles=collect_percentiles, deadline=deadline)


# -- on-disk cell cache ------------------------------------------------------

# op_latencies / load_stalls are deliberately NOT cached (they are large and
# rarely wanted); any call that needs them must bypass the cache entirely --
# otherwise a cache hit would silently return mean_op_latency == 0 where a
# cold run would not (see sweep_latency's ``use_cache`` predicate).  The
# percentile *summary* (a handful of floats) IS cached, so
# ``collect_percentiles`` sweeps stay incremental: a cell cached without a
# summary simply misses when a summary is requested (``need_summary``) and
# is recomputed and overwritten in place.
_CACHED_FIELDS = ("ops", "time", "throughput", "mem_stall_total",
                  "mem_accesses", "missed_ops")

# Bumped whenever the cell-file layout changes (v2: missed_ops +
# latency_summary).  Folded into every key, so a schema change simply
# orphans the old cells -- they age out via prune_sweep_cache instead of
# being misread (eviction-safe, no in-place migration).
_CACHE_SCHEMA = 2

# Source files whose semantics define what a cached cell means.  Their
# digest is folded into every cell key, so cells from an older revision of
# the simulator can never be served as current results (previously stale
# cells silently survived code changes).
_SALT_FILES = ("arrivals.py", "config.py", "devices.py", "engine_loop.py",
               "scheduler.py", "sweep.py", "replay_torch.py")
_CODE_SALT: str | None = None


def _code_salt() -> str:
    """Digest of the simulation-defining sources (cached per process)."""
    global _CODE_SALT
    if _CODE_SALT is None:
        here = os.path.dirname(os.path.abspath(__file__))
        core = os.path.dirname(here)
        paths = [os.path.join(here, name) for name in _SALT_FILES]
        paths.append(os.path.join(core, "trace_ir.py"))
        # the torch backend's scheduler/token-clock arithmetic lives in the
        # kernels package; every kernel source -- Python and CUDA -- defines
        # cached torch cells too, so hash both directories (sorted:
        # order-stable digest)
        kdir = os.path.join(os.path.dirname(core), "kernels")
        paths.extend(sorted(
            os.path.join(kdir, name) for name in os.listdir(kdir)
            if name.endswith(".py")))
        cdir = os.path.join(kdir, "csrc")
        paths.extend(sorted(
            os.path.join(cdir, name) for name in os.listdir(cdir)
            if name.endswith((".cu", ".cuh"))))
        h = hashlib.sha1()
        for path in paths:
            with open(path, "rb") as fh:
                h.update(fh.read())
        _CODE_SALT = h.hexdigest()[:16]
    return _CODE_SALT


def _cache_key(cfg: SimConfig, trace_digest: str, n_ops: int,
               warmup_ops, backend: str, arrival_key: str | None = None) -> str:
    # The backend is part of the key: loop and torch cells agree only within
    # tolerance, so a cached cell must never answer for the other backend.
    # The arrival spec is part of the key too (it changes every cell
    # value); the shared arrival array itself is NOT -- each cell consumes
    # a deterministic prefix that depends only on the spec and the cell's
    # own (n_threads, warmup, n_ops), so cells stay pure across sweeps
    # with different candidate lists.
    blob = json.dumps(
        [_CACHE_SCHEMA, repr(cfg), trace_digest, n_ops, warmup_ops, backend,
         arrival_key, _code_salt()],
        sort_keys=True,
    ).encode()
    return hashlib.sha1(blob).hexdigest()


# Cell files are "<sha1 hex>.json" (plus "<...>.json.tmp.<pid>" while a
# store is in flight); clear_sweep_cache must only ever match that shape --
# the cache dir may be a working directory holding scenario specs or
# artifact JSON that are NOT ours to delete.
_CELL_FILE = re.compile(r"^[0-9a-f]{40}\.json(\.tmp\.\d+)?$")


def clear_sweep_cache(cache_dir: str | os.PathLike) -> int:
    """Delete every memoized sweep cell in ``cache_dir``; returns the number
    of cells removed (in-flight temp files are removed but not counted).
    Only cell-shaped file names are touched; anything else in the
    directory is left alone.  Used by ``benchmarks.run
    --sweep-cache-clear``."""
    removed = 0
    try:
        names = os.listdir(cache_dir)
    except OSError:
        return 0
    for name in names:
        if _CELL_FILE.match(name):
            try:
                os.remove(os.path.join(str(cache_dir), name))
            except OSError:
                continue
            if name.endswith(".json"):
                removed += 1
    return removed


def prune_sweep_cache(
    cache_dir: str | os.PathLike,
    max_bytes: int | None = None,
    max_age_days: float | None = None,
) -> int:
    """Evict memoized sweep cells, least-recently-used first.

    ``max_age_days`` removes every cell whose mtime is older than that
    many days; ``max_bytes`` then removes the oldest remaining cells until
    the directory's cell bytes fit the budget.  ``_cache_load`` touches a
    cell's mtime on every hit, so mtime order is LRU order.  Stale
    in-flight temp files (``*.json.tmp.<pid>``) older than a day are
    swept unconditionally.  Only cell-shaped names are touched (see
    :func:`clear_sweep_cache`); returns the number of cells removed.
    Used by ``benchmarks.run --sweep-cache-prune``."""
    if max_bytes is not None and max_bytes < 0:
        raise ValueError(f"max_bytes must be >= 0, got {max_bytes}")
    if max_age_days is not None and max_age_days < 0:
        raise ValueError(f"max_age_days must be >= 0, got {max_age_days}")
    try:
        names = os.listdir(cache_dir)
    except OSError:
        return 0
    now = time.time()
    cells: list[tuple[float, int, str]] = []   # (mtime, size, path)
    for name in names:
        if not _CELL_FILE.match(name):
            continue
        path = os.path.join(str(cache_dir), name)
        try:
            st = os.stat(path)
        except OSError:
            continue
        if not name.endswith(".json"):         # orphaned temp file
            if now - st.st_mtime > 86400.0:
                try:
                    os.remove(path)
                except OSError:
                    pass
            continue
        cells.append((st.st_mtime, st.st_size, path))
    cells.sort()                               # oldest (least recent) first

    removed = 0

    def evict(entry: tuple[float, int, str]) -> bool:
        nonlocal removed
        try:
            os.remove(entry[2])
        except OSError:
            return False
        removed += 1
        return True

    if max_age_days is not None:
        cutoff = now - max_age_days * 86400.0
        keep = []
        for entry in cells:
            if entry[0] < cutoff:
                evict(entry)
            else:
                keep.append(entry)
        cells = keep
    if max_bytes is not None:
        total = sum(size for _, size, _ in cells)
        for entry in cells:
            if total <= max_bytes:
                break
            if evict(entry):
                total -= entry[1]
    return removed


def _cache_load(path: str, need_summary: bool = False) -> SimResult | None:
    try:
        with open(path) as f:
            d = json.load(f)
        summary = d.get("latency_summary")
        if need_summary and summary is None:
            # Cached before percentiles were requested: a miss, not an
            # error -- the recompute overwrites the cell with its summary.
            return None
        r = SimResult(
            **{k: d[k] for k in _CACHED_FIELDS},
            latency_summary=(LatencySummary.from_dict(summary)
                             if summary is not None else None))
    except (OSError, ValueError, KeyError, TypeError, AttributeError):
        # corrupt/foreign cells (non-JSON, wrong shape) are misses
        return None
    try:
        os.utime(path)   # mtime is the LRU clock for prune_sweep_cache
    except OSError:
        pass
    return r


def _cache_store(path: str, r: SimResult) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    doc = {k: getattr(r, k) for k in _CACHED_FIELDS}
    doc["latency_summary"] = (r.latency_summary.to_dict()
                              if r.latency_summary is not None else None)
    try:
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, path)
    except OSError:
        pass


def _make_point(L, candidates: list[int],
                evals: dict[int, SimResult]) -> SweepPoint:
    """Reduce evaluated cells of one latency point (lowest index wins ties,
    matching the full grid's first-candidate-wins rule)."""
    best_j = min(evals, key=lambda j: (-evals[j].throughput, j))
    return SweepPoint(
        L_mem=L,
        n_threads=candidates[best_j],
        result=evals[best_j],
        per_thread={candidates[j]: evals[j].throughput
                    for j in sorted(evals)},
    )


def sweep_latency(
    cfg: SimConfig,
    source,
    latencies: Iterable,
    thread_candidates: Iterable[int] = DEFAULT_THREAD_CANDIDATES,
    n_ops: int = 5000,
    warmup_ops: int | None = None,
    processes: int | None = None,
    cache_dir: str | os.PathLike | None = None,
    collect_latency: bool = False,
    adaptive: bool = False,
    backend: str = "torch",
    device=None,
    use_kernel: bool | None = None,
    substeps: int | None = None,
    arrival: ArrivalSpec | dict | None = None,
    collect_percentiles: bool = False,
    host_devices: int | None = None,
) -> list[SweepPoint]:
    """Throughput vs. memory latency with per-point thread optimization.

    Parameters
    ----------
    cfg
        Base configuration; ``L_mem`` and ``n_threads`` are overridden per
        grid cell (each cell keeps ``cfg.seed``, like the legacy protocol).
    source
        A :class:`CompiledTrace`, a ``TraceResult``, a legacy ``list[Op]``
        (compiled on the fly), or an op-source callable (runs through the
        generic loop; still parallelized).  Results are deterministic in
        both modes: parallel runs give every cell a pristine fork of the
        callable's state as of this call, serial runs thread it through
        the cells in fixed grid order.  Stateless sources (microbenchmark,
        compiled traces) are identical either way; for stateful legacy
        ``trace_source`` closures prefer passing the compiled trace.
    latencies
        Memory-latency points -- scalars in seconds, or mixture specs
        ``[(lat, prob), ...]``.
    thread_candidates
        Thread counts tried at every latency; earlier candidates win ties.
    processes
        Worker processes for the grid.  Default: up to the CPU count
        (capped by the grid size); ``0``/``1`` forces serial.  The start
        method is chosen automatically (``fork`` while CUDA is uninitialized,
        a preloaded ``forkserver`` otherwise; serial when neither is
        available or the source cannot cross a process boundary).
    cache_dir
        If set, finished cells are memoized as small JSON files keyed by
        (config, trace digest, n_ops, arrival spec); repeated sweeps only
        simulate new cells.  Bulk per-op collection is never cached: a
        ``collect_latency=True`` (or ``cfg.collect_load_hist``) call
        bypasses the cache entirely -- loads *and* stores -- because the
        cached cells drop ``op_latencies``/``load_stalls`` and a cache hit
        would silently return ``mean_op_latency == 0``.  The compact
        percentile summary IS cached: ``collect_percentiles`` sweeps hit
        the cache, and a cell cached without its summary is transparently
        recomputed (and upgraded) the first time percentiles are asked of
        it.
    collect_latency
        Record per-op latencies in every cell (``SimResult.op_latencies``),
        e.g. for Fig. 17-style latency curves.  Disables the cell cache.
    adaptive
        Warm-started thread search: the first latency point evaluates the
        full candidate list; every later point starts from the previous
        point's winner and only expands to neighboring candidates while the
        running best sits on the edge of the evaluated window.  Picks the
        same winner as the full grid whenever throughput vs. thread count
        is unimodal over the candidate list (the paper-sweep shape; see
        ``tests/test_sweep.py``), while evaluating far fewer cells.  Cells
        run serially (later points depend on earlier winners), so
        ``processes`` is ignored; ``per_thread`` only contains the
        candidates actually evaluated.
    backend
        ``"torch"`` (default) lowers the compiled trace to device tensors
        once and replays the entire scalar-latency grid on the device
        (:func:`repro_torch.core.sim.replay_torch.sweep_grid`): per-cell
        throughput agrees with the loops within sampling tolerance rather
        than bit-identically (see ``docs/PORT.md``), mixture-latency points
        still run through the loop per cell, and ``processes`` is ignored
        for the grid cells.  Requires a trace source (not a callable) and
        no latency/histogram collection; incompatible with
        ``adaptive=True``.  ``"loop"`` is the caller asking for the host
        interpreter: every cell runs through the interpreter loops
        (compiled fast path, generic fallback) as above.  Cached cells are
        keyed per backend, so the two never answer for each other.
    device, use_kernel, substeps, host_devices
        Torch-backend execution choices, forwarded to
        :func:`~repro_torch.core.sim.replay_torch.sweep_grid`: ``device``
        (``None`` means the CUDA device and raises without one; ``"cpu"``
        runs the plain PyTorch step on the host), ``use_kernel`` (``None``:
        the fused CUDA kernel on CUDA tensors, the plain step on CPU
        tensors), ``substeps`` (steps per kernel launch), ``host_devices``
        (each cohort's cells in N contiguous shards, one per CUDA device;
        one after another on the host).  Strategy knobs
        only -- cell values (and hence cache keys) do not depend on them;
        ignored by ``backend="loop"``.
    arrival
        An :class:`~repro_torch.core.sim.arrivals.ArrivalSpec` (or its dict
        form) switching every cell to the open-loop arrival mode: one shared
        deterministic timestamp stream (seconds; sized to the widest
        cell's demand) drives all cells and backends, ops wait for their
        arrival, and the spec's ``deadline`` classifies late sojourns as
        missed.  ``None`` (default) keeps the closed-loop mode.
    collect_percentiles
        Summarize each cell's measured sojourn latencies into
        ``SimResult.latency_summary`` (p50/p90/p99/max + missed count):
        exact nearest-rank on the loop backends, log-histogram on the torch
        backend (within ``arrivals.HIST_REL_ERROR``).  Cache-friendly,
        unlike ``collect_latency``.

    Returns one :class:`SweepPoint` per latency, in input order.
    """
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    latencies = list(latencies)
    candidates = list(thread_candidates)
    if not latencies or not candidates:
        return []
    trace, src_fn = _coerce_trace(source)

    if backend == "torch":
        if adaptive:
            raise ValueError(
                "backend='torch' evaluates the whole grid in one call; the "
                "warm-started adaptive search is a loop-backend strategy")
        if collect_latency or cfg.collect_load_hist:
            raise ValueError(
                "per-op latency / load-histogram collection is only "
                "available from backend='loop'")
        if trace is None:
            raise ValueError(
                "backend='torch' replays compiled traces; pass a "
                "CompiledTrace / TraceResult / list[Op], not a callable")

    arrival_spec: ArrivalSpec | None = None
    if arrival is not None:
        arrival_spec = (arrival if isinstance(arrival, ArrivalSpec)
                        else ArrivalSpec.from_dict(arrival))
    deadline = arrival_spec.deadline if arrival_spec is not None else 0.0
    arrivals_arr = None
    if arrival_spec is not None:
        # One shared stream sized to the widest cell's demand
        # (init threads + warmup + measured ops); every cell consumes its
        # own prefix, so the stream length never changes cell values.
        need = max(
            cfg.n_cores * c
            + (warmup_ops if warmup_ops is not None
               else 2 * c * cfg.n_cores)
            + n_ops
            for c in candidates) + 1
        arrivals_arr = generate_arrivals(arrival_spec, need)
    arrival_key = arrival_spec.key() if arrival_spec is not None else None

    use_cache = (cache_dir is not None and trace is not None
                 and not cfg.collect_load_hist and not collect_latency)
    digest = ""
    if use_cache:
        os.makedirs(cache_dir, exist_ok=True)
        digest = hashlib.sha1(
            trace.kinds.tobytes() + trace.durs.tobytes() +
            trace.bounds.tobytes()
        ).hexdigest()

    def cell_path(c: SimConfig) -> str:
        return os.path.join(
            str(cache_dir),
            _cache_key(c, digest, n_ops, warmup_ops, backend,
                       arrival_key) + ".json")

    if adaptive:
        return _sweep_adaptive(cfg, trace, src_fn, latencies, candidates,
                               n_ops, warmup_ops, collect_latency,
                               use_cache, cell_path, arrivals_arr,
                               collect_percentiles, deadline)

    grid_cfgs = [
        replace(cfg, L_mem=L, n_threads=n)
        for L in latencies
        for n in candidates
    ]

    # -- cache probe ---------------------------------------------------------
    paths: list[str | None] = [None] * len(grid_cfgs)
    results: list[SimResult | None] = [None] * len(grid_cfgs)
    if use_cache:
        for i, c in enumerate(grid_cfgs):
            paths[i] = cell_path(c)
            results[i] = _cache_load(paths[i],
                                     need_summary=collect_percentiles)

    todo = [i for i, r in enumerate(results) if r is None]

    # -- run missing cells ---------------------------------------------------
    if backend == "torch" and todo:
        grid_opts = {"device": device, "use_kernel": use_kernel}
        if substeps is not None:
            grid_opts["substeps"] = substeps
        if host_devices is not None:
            grid_opts["host_devices"] = host_devices
        _run_torch_cells(cfg, trace, latencies, candidates, n_ops,
                         warmup_ops, results, todo, grid_opts,
                         arrivals_arr, collect_percentiles, deadline)
        if use_cache:
            for i in todo:
                _cache_store(paths[i], results[i])
        todo = []
    if processes is None:
        processes = min(os.cpu_count() or 1, len(todo) or 1)
    ctx = _pick_context(trace, src_fn)
    if todo:
        if processes > 1 and ctx is not None and len(todo) > 1:
            # Callable sources may carry mutable state (trace_source
            # closures); giving every cell a pristine fork of the parent
            # state (maxtasksperchild=1) keeps parallel results
            # deterministic and identical to processes=1.
            with ctx.Pool(
                min(processes, len(todo)),
                initializer=_worker_init,
                initargs=(trace, src_fn, n_ops, warmup_ops, collect_latency,
                          arrivals_arr, collect_percentiles, deadline),
                maxtasksperchild=1 if src_fn is not None else None,
            ) as pool:
                for i, r in zip(todo,
                                pool.map(_worker_run,
                                         [grid_cfgs[i] for i in todo],
                                         chunksize=1)):
                    results[i] = r
        else:
            for i in todo:
                results[i] = _run_cell(grid_cfgs[i], trace, src_fn, n_ops,
                                       warmup_ops, collect_latency,
                                       arrivals_arr, collect_percentiles,
                                       deadline)
        if use_cache:
            for i in todo:
                _cache_store(paths[i], results[i])

    # -- reduce: best thread count per latency (first candidate wins ties) ---
    k = len(candidates)
    return [
        _make_point(L, candidates,
                    dict(enumerate(results[li * k:(li + 1) * k])))
        for li, L in enumerate(latencies)
    ]


def _sweep_adaptive(cfg, trace, src_fn, latencies, candidates, n_ops,
                    warmup_ops, collect_latency, use_cache,
                    cell_path, arrivals=None, collect_percentiles=False,
                    deadline=0.0) -> list[SweepPoint]:
    """Warm-started hill search over the candidate list, one point at a time.

    Invariant per latency point: the evaluated window ``[lo, hi]`` always
    contains the previous point's winner, and is expanded while the current
    best sits on a window edge -- so on a unimodal throughput-vs-threads
    curve the search provably reaches the global grid winner.
    """

    def eval_cell(c: SimConfig) -> SimResult:
        if use_cache:
            path = cell_path(c)
            r = _cache_load(path, need_summary=collect_percentiles)
            if r is not None:
                return r
        r = _run_cell(c, trace, src_fn, n_ops, warmup_ops, collect_latency,
                      arrivals, collect_percentiles, deadline)
        if use_cache:
            _cache_store(path, r)
        return r

    def argmax(evals: dict[int, SimResult]) -> int:
        return min(evals, key=lambda j: (-evals[j].throughput, j))

    k = len(candidates)
    out: list[SweepPoint] = []
    prev: int | None = None
    for L in latencies:
        evals: dict[int, SimResult] = {}
        if prev is None:                       # first point: full grid
            for j in range(k):
                evals[j] = eval_cell(replace(cfg, L_mem=L,
                                             n_threads=candidates[j]))
        else:
            lo, hi = max(prev - 1, 0), min(prev + 1, k - 1)
            for j in range(lo, hi + 1):
                evals[j] = eval_cell(replace(cfg, L_mem=L,
                                             n_threads=candidates[j]))
            best = argmax(evals)
            while best == lo and lo > 0:
                lo -= 1
                evals[lo] = eval_cell(replace(cfg, L_mem=L,
                                              n_threads=candidates[lo]))
                best = argmax(evals)
            while best == hi and hi < k - 1:
                hi += 1
                evals[hi] = eval_cell(replace(cfg, L_mem=L,
                                              n_threads=candidates[hi]))
                best = argmax(evals)
        prev = argmax(evals)
        out.append(_make_point(L, candidates, evals))
    return out
