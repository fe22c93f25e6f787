"""Declarative experiments: scenario specs, run options, run artifacts.

The paper's central artifact is a *protocol*: trace an engine under a
workload, sweep memory latency with the thread count re-optimized at every
point, and compare the simulated "measurement" against the closed-form
model (Figs. 9-13).  This module makes that protocol a first-class,
serializable object instead of benchmark-package glue:

  * :class:`Scenario` -- a frozen, JSON-round-trippable spec naming an
    engine (registry name + kwargs), a workload (registry name + kwargs,
    or the engine's default pairing), a device setup (``n_ssd`` /
    per-device ``R_io`` / ``B_io`` / ``L_switch_us``), and the sweep axes
    (latencies, thread candidates, simulated ops per cell).
  * :class:`RunOptions` -- *how* to run (worker processes, cell cache
    directory, latency collection, adaptive thread search); never part of
    the scientific spec, never serialized into artifacts' scenarios.
  * :class:`Experiment` -- traces the engine once, drives
    :func:`~repro_torch.core.sim.sweep_latency` over the grid, evaluates the
    paper's probabilistic model at every point, and returns a
  * :class:`RunArtifact` -- sweep table + trace stats (``S``, ``M``) +
    model predictions + full config provenance, with ``to_json`` /
    ``from_json`` round-trip and CSV export.

The engine -> default-workload pairings (previously
``benchmarks/common.py::ENGINE_DEFAULTS``) live here as
:data:`ENGINE_DEFAULTS`; :func:`default_scenario` builds the matrix cell
``benchmarks.run --engine NAME --devices N`` sweeps, so CLI flags are just
sugar over scenarios.  All latencies in a scenario are in **microseconds**
(the unit the paper's figures are drawn in); conversion to the simulator's
seconds happens inside :class:`Experiment`.
"""
from __future__ import annotations

import dataclasses
import io
import json
import math
from dataclasses import dataclass, field
from typing import Any, Sequence

import numpy as np

from .engines import TraceResult, get_engine, run_trace
from .latency_model import US, OpParams, theta_prob_inv
from .sim import ArrivalSpec, SimConfig, SweepPoint, sweep_latency
from .workloads import Workload, create_workload, get_workload

__all__ = [
    "ENGINE_DEFAULTS",
    "Scenario",
    "RunOptions",
    "SweepRow",
    "RunArtifact",
    "Experiment",
    "run_scenario",
    "default_scenario",
    "build_engine",
]

SCHEMA_VERSION = 1

#: Default (paper Table 5-ish) constructor kwargs and workload pairing per
#: canonical engine name: ``{engine: (engine_kwargs, workload,
#: workload_kwargs)}``.  A scenario whose ``workload`` is empty resolves it
#: from this table (unknown engines fall back to uniform read-only keys).
ENGINE_DEFAULTS: dict[str, tuple[dict, str, dict]] = {
    "tree-index": (dict(seed=1), "uniform", dict(read_write=(1, 0), seed=2)),
    "lsm": (dict(), "zipf", dict(exponent=0.99, read_write=(1, 0), seed=3)),
    "two-tier-cache": (
        dict(seed=4), "gaussian", dict(sigma_frac=0.08, read_write=(2, 1), seed=5),
    ),
    "hash-index": (dict(seed=6), "uniform", dict(read_write=(1, 0), seed=2)),
    "slab-cache": (dict(seed=8), "zipf", dict(exponent=0.9, read_write=(3, 1), seed=8)),
}

_FALLBACK_PAIRING = (dict(), "uniform", dict(read_write=(1, 0), seed=2))


def default_pairing(canonical_engine: str) -> tuple[dict, str, dict]:
    """``(engine_kwargs, workload, workload_kwargs)`` for one engine."""
    return ENGINE_DEFAULTS.get(canonical_engine, _FALLBACK_PAIRING)


def _expected_us(l_us) -> float:
    """Scalar latency, or a mixture spec's expected value, in us."""
    if isinstance(l_us, (tuple, list)):
        return sum(lat * prob for lat, prob in l_us)
    return float(l_us)


def _norm(v):
    """Normalize spec values so Python-built and JSON-loaded scenarios
    compare equal: sequences become tuples (recursively), dicts stay dicts
    with normalized values."""
    if isinstance(v, (list, tuple)):
        return tuple(_norm(x) for x in v)
    if isinstance(v, dict):
        return {k: _norm(x) for k, x in v.items()}
    return v


@dataclass(frozen=True)
class Scenario:
    """One declarative experiment: *what* to measure, as plain data.

    ``latencies_us`` entries are scalars (microseconds) or tail-latency
    mixtures ``((lat_us, prob), ...)``; ``L_switch_us`` is only paid when
    ``n_ssd > 1`` (a single direct-attached SSD has no switch to cross),
    mirroring the device-matrix semantics.  An empty ``workload`` selects
    the engine's default pairing from :data:`ENGINE_DEFAULTS`.
    """

    engine: str
    engine_kwargs: dict = field(default_factory=dict)
    workload: str = ""
    workload_kwargs: dict = field(default_factory=dict)
    n_keys: int = 100_000
    n_wl_ops: int = 30_000        # workload length fed to the engine trace
    warmup_frac: float = 0.3
    # device spec (R_io / B_io are per device; 0 disables the token clock)
    n_ssd: int = 1
    R_io: float = 0.0
    B_io: float = 0.0
    L_switch_us: float = 0.0
    # host spec: CPU cores running the store (thread_candidates are per
    # core) and the serialized per-op commit window (T_lock)
    n_cores: int = 1
    T_lock_us: float = 0.0
    # sweep axes
    latencies_us: tuple = (0.1, 1, 3, 5, 8, 10)
    thread_candidates: tuple = (16, 24, 32, 48, 64)
    n_ops: int = 5000             # simulated ops per grid cell
    P: int = 12
    T_sw_us: float = 0.05
    seed: int = 7
    # open-loop arrival mode: an ArrivalSpec.to_dict() (empty = closed loop).
    # NOTE: ArrivalSpec fields are SI -- ``rate`` in ops/sec, ``period``
    # and ``deadline`` in *seconds* -- unlike the scenario's _us fields.
    arrival: dict = field(default_factory=dict)
    # sharded fleet: a ClusterSpec.to_dict() (empty = single host).  The
    # scenario's device fields describe each *node*; ``cluster`` adds the
    # fleet shape on top (node count, partitioning, route hop, per-node
    # overrides) -- see repro_torch.core.cluster.
    cluster: dict = field(default_factory=dict)
    name: str = ""

    def __post_init__(self):
        for f in ("engine_kwargs", "workload_kwargs", "latencies_us",
                  "thread_candidates", "arrival", "cluster"):
            object.__setattr__(self, f, _norm(getattr(self, f)))
        if self.arrival:
            ArrivalSpec.from_dict(dict(self.arrival))   # validate eagerly
        if self.cluster:
            from .cluster import ClusterSpec
            ClusterSpec.from_dict(dict(self.cluster))   # validate eagerly
        if not self.latencies_us or not self.thread_candidates:
            raise ValueError(
                "Scenario sweep axes must be non-empty "
                f"(latencies_us={self.latencies_us!r}, "
                f"thread_candidates={self.thread_candidates!r})"
            )
        if self.n_ssd < 1:
            raise ValueError(f"n_ssd must be >= 1, got {self.n_ssd}")
        if self.n_cores < 1:
            raise ValueError(f"n_cores must be >= 1, got {self.n_cores}")
        if self.T_lock_us < 0:
            raise ValueError(
                f"T_lock_us must be >= 0, got {self.T_lock_us}")
        for f in ("n_keys", "n_wl_ops", "n_ops"):
            if getattr(self, f) < 1:
                raise ValueError(f"{f} must be >= 1, got {getattr(self, f)}")

    # -- resolution ----------------------------------------------------------

    @property
    def canonical_engine(self) -> str:
        return get_engine(self.engine).engine_name

    def resolved_workload(self) -> tuple[str, dict]:
        """Workload registry name + kwargs, applying the default pairing."""
        if self.workload:
            return get_workload(self.workload).workload_name, dict(
                self.workload_kwargs)
        _, wname, wkw = default_pairing(self.canonical_engine)
        return wname, {**wkw, **self.workload_kwargs}

    @property
    def display_name(self) -> str:
        return self.name or (
            f"{self.canonical_engine.replace('-', '_')}_{self.n_ssd}ssd")

    def sim_config(self) -> SimConfig:
        """The base :class:`SimConfig` of every grid cell (``L_mem`` and
        ``n_threads`` are overridden per cell by the sweep)."""
        return SimConfig(
            P=self.P, T_sw=self.T_sw_us * US, seed=self.seed,
            n_ssd=self.n_ssd, R_io=self.R_io, B_io=self.B_io,
            L_switch=self.L_switch_us * US if self.n_ssd > 1 else 0.0,
            n_cores=self.n_cores, T_lock=self.T_lock_us * US,
        )

    def latencies_sec(self) -> list:
        """Latency axis in the simulator's scalar-or-mixture seconds form."""
        return [
            [(lat * US, prob) for lat, prob in l]
            if isinstance(l, tuple) else l * US
            for l in self.latencies_us
        ]

    def arrival_spec(self) -> ArrivalSpec | None:
        """The open-loop :class:`~repro_torch.core.sim.ArrivalSpec`, or ``None``
        for the closed-loop mode."""
        return (ArrivalSpec.from_dict(dict(self.arrival))
                if self.arrival else None)

    def cluster_spec(self):
        """The :class:`~repro_torch.core.cluster.ClusterSpec`, or ``None``
        for the plain single-host path."""
        if not self.cluster:
            return None
        from .cluster import ClusterSpec
        return ClusterSpec.from_dict(dict(self.cluster))

    # -- serialization -------------------------------------------------------

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "Scenario":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(
                f"unknown Scenario field(s) {sorted(unknown)}; "
                f"known: {sorted(known)}"
            )
        return cls(**d)

    def to_json(self, indent: int | None = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    @classmethod
    def from_json(cls, s: str) -> "Scenario":
        return cls.from_dict(json.loads(s))


@dataclass(frozen=True)
class RunOptions:
    """How to execute a scenario (absorbs the old module-level
    ``SWEEP_PROCESSES`` / ``SWEEP_CACHE`` benchmark globals); never part
    of an artifact's provenance.  ``processes``/``cache_dir`` cannot change
    the numbers; ``collect_latency`` only *adds* the latency column;
    ``adaptive`` evaluates a subset of the thread grid (``per_thread``
    covers fewer candidates, and the winner matches the full grid only on
    unimodal throughput-vs-threads curves -- the paper-sweep shape; see
    :func:`~repro_torch.core.sim.sweep_latency`).  ``backend="torch"`` (the
    default) replays the grid on the device; its per-cell throughput agrees
    with ``backend="loop"`` (the host interpreter) within sampling
    tolerance, not bit-identically (the scientific spec is unchanged -- the
    measurement apparatus is; see ``docs/PORT.md``).  ``device=None`` means
    the CUDA device and raises without one; ``"cpu"`` asks for the host.
    ``use_kernel``/``substeps``/``host_devices`` choose how the grid
    executes (fused CUDA step kernel, steps per launch, cell shards over N
    CUDA devices) without changing any cell value."""

    processes: int | None = None       # sweep worker processes (None: auto)
    cache_dir: str | None = None       # on-disk sweep-cell cache
    collect_latency: bool = False      # per-op latencies per winning cell
    collect_percentiles: bool = False  # p50/p90/p99 tail summary per cell
    adaptive: bool = False             # warm-started thread search
    backend: str = "torch"             # "torch" device grid | "loop" host
    device: Any = None                 # torch: None = "cuda"; "cpu" on ask
    use_kernel: bool | None = None     # torch: fused CUDA step (None: auto)
    substeps: int | None = None        # torch: steps per kernel launch
    host_devices: int | None = None    # torch: shard cells over N devices


@dataclass(frozen=True)
class SweepRow:
    """One latency point of an artifact's sweep table."""

    L_us: Any                     # scalar us, or ((lat_us, prob), ...)
    n_threads: int
    throughput: float             # ops/sec at the best thread count
    model_throughput: float       # paper probabilistic model at this point
    per_thread: tuple = ()        # ((n_threads, throughput), ...)
    mean_op_latency_us: float | None = None
    # Tail summary of the winning cell when RunOptions.collect_percentiles
    # was on (None otherwise, and in artifacts predating it): p50_us /
    # p90_us / p99_us / max_us (None when every op missed), count, missed,
    # miss_rate, source ("exact" | "hist"), offered_load (ops/sec, None
    # closed loop) and achieved_load (measured throughput).
    tail: dict | None = None
    # Cluster runs only: one dict per node (node index, op-stream share,
    # measured ops, throughput, virtual time, and the node's own tail
    # summary in the client frame).  None on single-host rows.
    nodes: tuple | None = None

    def __post_init__(self):
        object.__setattr__(self, "L_us", _norm(self.L_us))
        object.__setattr__(self, "per_thread", _norm(self.per_thread))
        if self.tail is not None:
            object.__setattr__(self, "tail", dict(self.tail))
        if self.nodes is not None:
            object.__setattr__(self, "nodes", _norm(tuple(self.nodes)))

    @property
    def mean_latency_us(self) -> float:
        """Scalar latency, or the mixture's expected value, in us."""
        return _expected_us(self.L_us)

    def label(self) -> str:
        if isinstance(self.L_us, tuple):
            return "Lmix" + "|".join(f"{lat:g}@{prob:g}"
                                     for lat, prob in self.L_us) + "us"
        return f"L{self.L_us:g}us"


@dataclass
class RunArtifact:
    """Everything one experiment run produced, as serializable data.

    ``points`` / ``trace_result`` are live in-process handles (the raw
    :class:`SweepPoint` list and :class:`TraceResult`) populated by
    :meth:`Experiment.run`; they are excluded from equality and JSON, so
    ``RunArtifact.from_json(a.to_json()) == a`` holds.
    """

    scenario: Scenario
    engine: str                   # canonical registry names, resolved
    workload: str
    S: float                      # SSD accesses per op (trace-measured)
    M: float                      # slow-memory hops per op
    T_mem_us: float               # calibrated model spans (Sec. 4.2.3)
    T_io_pre_us: float
    T_io_post_us: float
    hit_stats: dict = field(default_factory=dict)
    rows: tuple = ()              # tuple[SweepRow, ...]
    schema_version: int = SCHEMA_VERSION
    points: list = field(default=None, compare=False, repr=False)
    trace_result: TraceResult | None = field(
        default=None, compare=False, repr=False)

    def __post_init__(self):
        self.rows = tuple(
            r if isinstance(r, SweepRow) else SweepRow(**r)
            for r in self.rows
        )
        self.hit_stats = {k: _jsonable(v) for k, v in self.hit_stats.items()}

    # -- views ---------------------------------------------------------------

    @property
    def baseline_throughput(self) -> float:
        return self.rows[0].throughput if self.rows else 0.0

    def normalized(self) -> list[float]:
        """Throughput per point normalized by the first (DRAM-ish) point."""
        base = self.baseline_throughput
        return [r.throughput / base for r in self.rows] if base else []

    def op_params(self) -> OpParams:
        """The calibrated model parameters this artifact's predictions used."""
        return OpParams(
            M=self.M, S=max(self.S, 1e-9), T_mem=self.T_mem_us * US,
            T_io_pre=self.T_io_pre_us * US, T_io_post=self.T_io_post_us * US,
            T_sw=self.scenario.T_sw_us * US, P=self.scenario.P,
        )

    # -- serialization -------------------------------------------------------

    def to_dict(self) -> dict:
        d = {
            "schema_version": self.schema_version,
            "scenario": self.scenario.to_dict(),
            "engine": self.engine,
            "workload": self.workload,
            "S": self.S,
            "M": self.M,
            "T_mem_us": self.T_mem_us,
            "T_io_pre_us": self.T_io_pre_us,
            "T_io_post_us": self.T_io_post_us,
            "hit_stats": self.hit_stats,
            "rows": [dataclasses.asdict(r) for r in self.rows],
        }
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "RunArtifact":
        d = dict(d)
        version = d.pop("schema_version", SCHEMA_VERSION)
        if version > SCHEMA_VERSION:
            raise ValueError(
                f"artifact schema_version {version} is newer than "
                f"supported {SCHEMA_VERSION}"
            )
        d["scenario"] = Scenario.from_dict(d["scenario"])
        return cls(schema_version=version, **d)

    def to_json(self, indent: int | None = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    @classmethod
    def from_json(cls, s: str) -> "RunArtifact":
        return cls.from_dict(json.loads(s))

    def to_csv(self) -> str:
        """The sweep table as CSV (one row per latency point)."""
        buf = io.StringIO()
        buf.write("L_us,n_threads,throughput_ops,model_throughput_ops,"
                  "normalized,mean_op_latency_us\n")
        base = self.baseline_throughput or 1.0
        for r in self.rows:
            l_col = (f"{r.mean_latency_us:g}" if isinstance(r.L_us, tuple)
                     else f"{r.L_us:g}")
            lat = ("" if r.mean_op_latency_us is None
                   else f"{r.mean_op_latency_us:.4f}")
            buf.write(f"{l_col},{r.n_threads},{r.throughput:.4f},"
                      f"{r.model_throughput:.4f},"
                      f"{r.throughput / base:.6f},{lat}\n")
        return buf.getvalue()


def _jsonable(v):
    """Coerce numpy scalars etc. so artifacts always json.dumps cleanly."""
    if isinstance(v, (bool, np.bool_)):
        return bool(v)
    if isinstance(v, (int, np.integer)):
        return int(v)
    if isinstance(v, (float, np.floating)):
        return float(v)
    if isinstance(v, (str, type(None))):
        return v
    return str(v)


def build_engine(name: str, n_keys: int = 100_000, n_wl_ops: int = 30_000
                 ) -> tuple[Any, Workload]:
    """One registered engine + its default workload, by any registry name.

    Accepts canonical names, aliases, and CLI-style underscores
    (``hash_index``); unknown engines raise ``KeyError`` listing what is
    registered.
    """
    cls = get_engine(name)
    kw, wname, wkw = default_pairing(cls.engine_name)
    return cls(n_keys, **kw), create_workload(wname, n_keys, n_wl_ops, **wkw)


class Experiment:
    """Execute one :class:`Scenario`: trace once, sweep the grid, compare
    against the analytical model, and package a :class:`RunArtifact`.

    >>> art = Experiment(default_scenario("hash-index", n_ssd=2)).run()
    """

    def __init__(self, scenario: Scenario, options: RunOptions | None = None):
        self.scenario = scenario
        self.options = options or RunOptions()

    def build(self) -> tuple[Any, Workload]:
        """Instantiate the scenario's engine and workload."""
        s = self.scenario
        store = get_engine(s.engine)(s.n_keys, **s.engine_kwargs)
        wname, wkw = s.resolved_workload()
        wl = create_workload(wname, s.n_keys, s.n_wl_ops, **wkw)
        return store, wl

    def run(self) -> RunArtifact:
        s, o = self.scenario, self.options
        store, wl = self.build()
        tr = run_trace(store, wl, warmup_frac=s.warmup_frac)
        p = tr.op_params(store.times, P=s.P, T_sw=s.T_sw_us * US)
        cfg = s.sim_config()
        arrival = s.arrival_spec()
        cl = s.cluster_spec()
        if cl is not None:
            from .cluster import sweep_cluster
            # Trace ops carry no keys; the partitioner needs them, and the
            # post-warmup workload slice aligns 1:1 with the trace ops.
            n_warm = int(len(wl) * s.warmup_frac)
            pts = sweep_cluster(
                cfg, tr.trace, wl.keys[n_warm:], wl.is_write[n_warm:], cl,
                s.latencies_sec(), s.thread_candidates, n_ops=s.n_ops,
                backend=o.backend, collect_latency=o.collect_latency,
                collect_percentiles=o.collect_percentiles, arrival=arrival,
                device=o.device, use_kernel=o.use_kernel,
                substeps=o.substeps, host_devices=o.host_devices,
            )
        else:
            pts = sweep_latency(
                cfg, tr.trace, s.latencies_sec(), s.thread_candidates,
                n_ops=s.n_ops, processes=o.processes, cache_dir=o.cache_dir,
                collect_latency=o.collect_latency, adaptive=o.adaptive,
                backend=o.backend, device=o.device, use_kernel=o.use_kernel,
                substeps=o.substeps, host_devices=o.host_devices,
                arrival=arrival, collect_percentiles=o.collect_percentiles,
            )
        # Eq. 14 outer IO caps for the model column, matching the scenario's
        # declared device pool (aggregate over the n_ssd per-device rates;
        # 0 disables a cap, like in the simulator).
        cap_inv = 0.0
        if s.R_io > 0:
            cap_inv = max(cap_inv, p.S / (s.n_ssd * s.R_io))
        if s.B_io > 0:
            cap_inv = max(cap_inv, p.S * cfg.A_io / (s.n_ssd * s.B_io))
        # Cluster fleet model: the hottest shard saturates first, so the
        # fleet tops out at min over nodes of C_k / w_k (node capacity
        # from Eq. 14 with its own device overrides, over its op share).
        shares = None
        if cl is not None and pts:
            shares = []
            for nc in pts[0].nodes:
                if nc.share <= 0.0:
                    continue
                ncfg = cl.node_config(cfg, nc.node)
                ci = 0.0
                if ncfg.R_io > 0:
                    ci = max(ci, p.S / (ncfg.n_ssd * ncfg.R_io))
                if ncfg.B_io > 0:
                    ci = max(ci, p.S * ncfg.A_io / (ncfg.n_ssd * ncfg.B_io))
                shares.append((nc.share, ci))
        rows = tuple(
            _make_row(l_us, pt, p, cap_inv, o.collect_latency, arrival,
                      shares=shares, nodes=_node_dicts(pt, arrival))
            for l_us, pt in zip(s.latencies_us, pts)
        )
        wname, _ = s.resolved_workload()
        return RunArtifact(
            scenario=s,
            engine=s.canonical_engine,
            workload=wname,
            S=float(tr.io_per_op),
            M=float(tr.mem_per_op),
            T_mem_us=float(p.T_mem / US),
            T_io_pre_us=float(p.T_io_pre / US),
            T_io_post_us=float(p.T_io_post / US),
            hit_stats=dict(tr.hit_stats),
            rows=rows,
            points=pts,
            trace_result=tr,
        )


def _summary_tail(summ, offered: float | None,
                  achieved: float) -> dict | None:
    """Flatten a :class:`LatencySummary` into the JSON-friendly tail
    mapping (microseconds; NaN percentiles from all-missed cells become
    ``None`` so artifacts round-trip through strict JSON)."""
    if summ is None:
        return None

    def us_or_none(v: float) -> float | None:
        return None if math.isnan(v) else float(v) / US

    return {
        "p50_us": us_or_none(summ.p50),
        "p90_us": us_or_none(summ.p90),
        "p99_us": us_or_none(summ.p99),
        "max_us": us_or_none(summ.max),
        "count": int(summ.count),
        "missed": int(summ.missed),
        "miss_rate": float(summ.miss_rate),
        "source": summ.source,
        "offered_load": offered,
        "achieved_load": float(achieved),
    }


def _tail_dict(pt: SweepPoint, arrival: ArrivalSpec | None) -> dict | None:
    return _summary_tail(
        pt.result.latency_summary,
        float(arrival.offered_rate) if arrival is not None else None,
        pt.throughput)


def _node_dicts(pt: SweepPoint,
                arrival: ArrivalSpec | None) -> tuple | None:
    """Per-node breakdown of a cluster point as JSON-friendly dicts (a
    node's offered load is the fleet offered rate times its op share)."""
    nodes = getattr(pt, "nodes", None)
    if not nodes:
        return None
    out = []
    for nc in nodes:
        offered = (float(arrival.offered_rate) * nc.share
                   if arrival is not None else None)
        out.append({
            "node": int(nc.node),
            "share": float(nc.share),
            "n_ops": int(nc.n_ops),
            "throughput": float(nc.throughput),
            "time": float(nc.time),
            "tail": _summary_tail(nc.summary, offered, nc.throughput),
        })
    return tuple(out)


def _make_row(l_us, pt: SweepPoint, p: OpParams, cap_inv: float,
              collected: bool, arrival: ArrivalSpec | None = None,
              shares=None, nodes=None) -> SweepRow:
    # Mixtures are fed to the closed-form model as their expected latency
    # (the model takes a scalar L; the simulator samples the real mixture).
    # cap_inv is the Eq. 14 device-cap floor on reciprocal throughput, so
    # IOPS/bandwidth-capped scenarios get a model the sim can actually meet.
    # shares (cluster runs) replaces it with the hottest-shard bound
    # min_k C_k / w_k over (op share, per-node cap floor) pairs.
    rev = float(theta_prob_inv(np.array([_expected_us(l_us) * US]), p)[0])
    if shares is None:
        model = 1.0 / max(rev, cap_inv)
    else:
        model = min((1.0 / max(rev, ci)) / w for w, ci in shares)
    return SweepRow(
        L_us=l_us,
        n_threads=pt.n_threads,
        throughput=float(pt.throughput),
        model_throughput=model,
        per_thread=tuple(pt.per_thread.items()),
        mean_op_latency_us=(
            float(pt.result.mean_op_latency / US) if collected else None),
        tail=_tail_dict(pt, arrival),
        nodes=nodes,
    )


def run_scenario(scenario: Scenario,
                 options: RunOptions | None = None) -> RunArtifact:
    """Convenience: ``Experiment(scenario, options).run()``."""
    return Experiment(scenario, options).run()


def default_scenario(engine: str, n_ssd: int = 1, **overrides) -> Scenario:
    """The engine x device matrix cell as a scenario (what
    ``benchmarks.run --engine NAME --devices N`` sweeps).

    Device defaults give each SSD a 250 kIOPS random-read token clock --
    one device caps the IO-richest engines while two free them -- and
    pools with ``n_ssd > 1`` pay a 0.3 us switch fan-out hop per IO.
    Any :class:`Scenario` field can be overridden by keyword.
    """
    cls = get_engine(engine)
    ekw, wname, wkw = default_pairing(cls.engine_name)
    spec = dict(
        engine=cls.engine_name,
        engine_kwargs=ekw,
        workload=wname,
        workload_kwargs=wkw,
        n_ssd=n_ssd,
        R_io=250e3,
        L_switch_us=0.3,
    )
    spec.update(overrides)
    return Scenario(**spec)
