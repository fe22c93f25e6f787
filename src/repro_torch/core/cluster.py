"""Sharded-cluster simulation: one host -> a fleet behind a router.

The paper's Eq. 14 analysis is single-host.  Real SSD-backed KV services
that would adopt microsecond-latency memory run as *sharded fleets*: a
router resolves every request to a shard, pays a routing hop, and the
request then executes against that node's engine and device clocks.  This
module grows the single-host pipeline into that shape without touching the
per-node scheduler arithmetic -- a cluster is composed out of the existing
cells, so every per-node result keeps the loop/grid equivalence contracts.

The model
---------
A :class:`ClusterSpec` declares the fleet: node count, hash or key-range
partitioning, replication factor with a read-replica policy, the router
hop ``L_route_us``, optional per-node device overrides (a degraded node is
just ``io_degrade``/``T_degrade_us`` on one node), and an optional
shard-migration event.  Given the compiled trace *and the per-op keys*
(recovered from the workload; trace ops carry no keys), the partitioner
assigns every trace op to a node.  Each node then runs the existing
single-host simulation over its own sub-trace:

  * its ops, in stream order, as a
    :class:`~repro_torch.core.trace_ir.CompiledTrace`;
  * its own :class:`~repro_torch.core.sim.SimConfig` (base config +
    overrides, seed decorrelated per node);
  * its share of the measured ops (largest-remainder apportionment, so
    shares sum exactly to ``n_ops``);
  * under open-loop load, the client arrival stream *routed*: client
    arrival ``i`` goes to the node owning trace op ``i mod n_trace``, and
    reaches it ``L_route`` later.

The routing recurrence is one stage in front of the per-node scheduler
recurrence: with client arrival :math:`A_i`, the node sees the op at
:math:`A_i + L_{route}`, the node's unchanged recurrence produces the node
sojourn :math:`W_i`, and the client-observed sojourn is
:math:`W_i + L_{route}` (the hop is paid once, inbound; SLA deadlines are
checked in the client frame by giving nodes ``deadline - L_route``).

Fleet reduction: at every (latency, thread-count) cell the fleet
throughput is the sum of node throughputs; the winning thread count is
chosen fleet-wide (same count on every node, first candidate wins ties,
matching :func:`~repro_torch.core.sim.sweep_latency`).  Tail summaries are
reported per node *and* fleet-wide -- exactly merged from per-op sojourns
on the loop backends, merged log-histogram counts on the torch grid.

Degeneracy contract: a trivial spec (one node, replication 1, zero route
hop, no overrides, no migration) reproduces the plain single-host path
byte-for-byte on the generic and compiled loops and bit-identically on
the torch grid -- same sub-trace object, same config, same arrival stream,
same winner rule; see ``tests/test_torch_cluster.py``.

Cluster sweeps do not use the on-disk cell cache: cells are keyed by
sub-traces derived from (trace, keys, spec), and the cluster benchmark
surface is small enough that recomputing is cheaper than proving those
keys stable.
"""
from __future__ import annotations

import dataclasses
import json
import numbers
from dataclasses import dataclass, field, replace
from typing import Iterable, Sequence

import numpy as np

from .sim.arrivals import (
    ArrivalSpec,
    LatencySummary,
    generate_arrivals,
    summarize_exact,
    summarize_hist,
)
from .sim.config import SimConfig, SimResult
from .sim.engine_loop import simulate, simulate_compiled
from .sim.sweep import SweepPoint
from .trace_ir import US, CompiledTrace

__all__ = [
    "ClusterSpec",
    "ClusterPlan",
    "NodeCell",
    "ClusterPoint",
    "shard_of",
    "assign_ops",
    "build_plan",
    "sweep_cluster",
    "CLUSTER_BACKENDS",
]

#: Cluster sweeps run per-node cells on one of the three backends: the
#: compiled fast loop, the generic event loop (equivalence harness), or
#: the device grid (the default, as in ``RunOptions``).
CLUSTER_BACKENDS = ("loop", "generic", "torch")

# Knuth multiplicative hash -- the same constant the zipf workloads use to
# scatter ranked keys, so hash partitioning is uniform over key space.
_HASH_MULT = np.uint64(2654435761)
_HASH_MASK = np.uint64(0xFFFFFFFF)

#: Per-node SimConfig override keys accepted in ``node_overrides`` values
#: (``*_us`` fields are microseconds, converted on application).
NODE_OVERRIDE_FIELDS = ("R_io", "B_io", "n_ssd", "L_switch_us", "L_io_us",
                        "io_degrade", "T_degrade_us")


@dataclass(frozen=True)
class ClusterSpec:
    """Declarative fleet shape, JSON-round-trippable like ``ArrivalSpec``.

    ``node_overrides`` maps node index (as a *string*, the JSON object key
    form) to a dict of :data:`NODE_OVERRIDE_FIELDS`; ``migrate`` is empty
    or ``{"shard": s, "to": t, "at_frac": f}`` -- ops in the trailing
    ``1 - f`` fraction of the op stream whose primary shard is ``s`` are
    served by node ``t`` instead (a handover under load).
    """

    n_nodes: int = 1
    partition: str = "hash"            # "hash" | "range"
    replication: int = 1
    replica_policy: str = "primary"    # "primary" | "spread"
    L_route_us: float = 0.0
    node_overrides: dict = field(default_factory=dict)
    migrate: dict = field(default_factory=dict)

    def __post_init__(self):
        if self.n_nodes < 1:
            raise ValueError(f"n_nodes must be >= 1, got {self.n_nodes}")
        if self.partition not in ("hash", "range"):
            raise ValueError(
                f"partition must be 'hash' or 'range', got "
                f"{self.partition!r}")
        if not 1 <= self.replication <= self.n_nodes:
            raise ValueError(
                f"replication must be in [1, n_nodes={self.n_nodes}], got "
                f"{self.replication}")
        if self.replica_policy not in ("primary", "spread"):
            raise ValueError(
                f"replica_policy must be 'primary' or 'spread', got "
                f"{self.replica_policy!r}")
        if self.L_route_us < 0:
            raise ValueError(
                f"L_route_us must be >= 0, got {self.L_route_us}")
        for node, ov in dict(self.node_overrides).items():
            try:
                idx = int(node)
            except (TypeError, ValueError):
                raise ValueError(
                    f"node_overrides keys must be node indices, got "
                    f"{node!r}") from None
            if not 0 <= idx < self.n_nodes:
                raise ValueError(
                    f"node_overrides key {node!r} outside "
                    f"[0, {self.n_nodes})")
            unknown = set(ov) - set(NODE_OVERRIDE_FIELDS)
            if unknown:
                raise ValueError(
                    f"unknown node override field(s) {sorted(unknown)} for "
                    f"node {node}; known: {list(NODE_OVERRIDE_FIELDS)}")
            for k, v in ov.items():
                if not isinstance(v, numbers.Real):
                    raise ValueError(
                        f"node override {k}={v!r} must be numeric")
        if self.migrate:
            mig = dict(self.migrate)
            unknown = set(mig) - {"shard", "to", "at_frac"}
            if unknown:
                raise ValueError(
                    f"unknown migrate field(s) {sorted(unknown)}; known: "
                    "['shard', 'to', 'at_frac']")
            for k in ("shard", "to", "at_frac"):
                if k not in mig:
                    raise ValueError(f"migrate requires {k!r}")
            if not 0 <= int(mig["shard"]) < self.n_nodes:
                raise ValueError(
                    f"migrate shard {mig['shard']} outside "
                    f"[0, {self.n_nodes})")
            if not 0 <= int(mig["to"]) < self.n_nodes:
                raise ValueError(
                    f"migrate to {mig['to']} outside [0, {self.n_nodes})")
            if int(mig["shard"]) == int(mig["to"]):
                raise ValueError("migrate shard and to must differ")
            if not 0.0 <= float(mig["at_frac"]) <= 1.0:
                raise ValueError(
                    f"migrate at_frac must be in [0, 1], got "
                    f"{mig['at_frac']}")

    @property
    def is_trivial(self) -> bool:
        """True when the spec degenerates to the plain single-host path."""
        return (self.n_nodes == 1 and self.L_route_us == 0.0
                and not self.node_overrides and not self.migrate)

    @property
    def L_route(self) -> float:
        return self.L_route_us * US

    def node_config(self, cfg: SimConfig, node: int) -> SimConfig:
        """``cfg`` with this node's device overrides and decorrelated seed
        applied (node 0 with no overrides returns ``cfg`` itself)."""
        ov = dict(self.node_overrides.get(str(node), {}))
        kw = {}
        if "R_io" in ov:
            kw["R_io"] = float(ov["R_io"])
        if "B_io" in ov:
            kw["B_io"] = float(ov["B_io"])
        if "n_ssd" in ov:
            kw["n_ssd"] = int(ov["n_ssd"])
        if "L_switch_us" in ov:
            kw["L_switch"] = float(ov["L_switch_us"]) * US
        if "L_io_us" in ov:
            kw["L_io"] = float(ov["L_io_us"]) * US
        if "io_degrade" in ov:
            kw["io_degrade"] = float(ov["io_degrade"])
        if "T_degrade_us" in ov:
            kw["T_degrade"] = float(ov["T_degrade_us"]) * US
        if node:
            kw["seed"] = cfg.seed + node
        return replace(cfg, **kw) if kw else cfg

    # -- serialization -------------------------------------------------------

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "ClusterSpec":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(
                f"unknown ClusterSpec field(s) {sorted(unknown)}; known: "
                f"{sorted(known)}")
        return cls(**d)

    def key(self) -> str:
        """Canonical string form, stable across processes."""
        return json.dumps(self.to_dict(), sort_keys=True)


# -- partitioners ------------------------------------------------------------
#
# Pure numpy functions of (keys, spec) shared by every backend, so shard
# assignment is byte-identical no matter which backend replays the cells.


def shard_of(keys, spec: ClusterSpec, n_keys: int) -> np.ndarray:
    """Primary shard of each key (int64 array in ``[0, n_nodes)``)."""
    k = np.asarray(keys, dtype=np.int64)
    if k.size and (k.min() < 0 or k.max() >= n_keys):
        raise ValueError(
            f"keys must lie in [0, n_keys={n_keys}), got range "
            f"[{k.min()}, {k.max()}]")
    if spec.partition == "range":
        # Contiguous key ranges of near-equal width; the last node absorbs
        # the remainder so every key in [0, n_keys) maps in-range.
        return np.minimum(k * spec.n_nodes // n_keys, spec.n_nodes - 1)
    h = (k.astype(np.uint64) * _HASH_MULT) & _HASH_MASK
    return (h % np.uint64(spec.n_nodes)).astype(np.int64)


def replica_set(shard: int, spec: ClusterSpec) -> tuple[int, ...]:
    """Nodes holding a copy of ``shard``: primary plus the next
    ``replication - 1`` nodes in ring order."""
    return tuple((shard + j) % spec.n_nodes for j in range(spec.replication))


def assign_ops(keys, is_write, spec: ClusterSpec, n_keys: int) -> np.ndarray:
    """Serving node of each op in the trace-op stream (int64 array).

    Writes always execute at the primary.  With ``replica_policy ==
    "spread"`` reads rotate over the shard's replica set by op-stream
    index; ``"primary"`` sends reads to the primary too (replicas are then
    capacity headroom only).  A ``migrate`` event reassigns the migrated
    shard's ops from the cut index onward.
    """
    shard = shard_of(keys, spec, n_keys)
    node = shard.copy()
    w = np.asarray(is_write, dtype=bool)
    if w.shape != shard.shape:
        raise ValueError(
            f"keys and is_write disagree: {shard.shape} vs {w.shape}")
    if spec.replication > 1 and spec.replica_policy == "spread":
        idx = np.arange(len(node), dtype=np.int64)
        reads = ~w
        node[reads] = (shard[reads]
                       + idx[reads] % spec.replication) % spec.n_nodes
    if spec.migrate:
        cut = int(float(spec.migrate["at_frac"]) * len(node))
        moved = (np.arange(len(node)) >= cut) & (
            shard == int(spec.migrate["shard"]))
        node[moved] = int(spec.migrate["to"])
    return node


def _subtrace(trace: CompiledTrace, mask: np.ndarray) -> CompiledTrace | None:
    """The ops selected by ``mask``, in stream order, as a new trace.

    Selecting every op returns the *original* trace object (identity, so
    the trivial cluster replays the exact same arrays and ``as_lists``
    cache); selecting none returns ``None``.
    """
    if mask.all():
        return trace
    if not mask.any():
        return None
    starts, ends = trace.bounds[:-1][mask], trace.bounds[1:][mask]
    idx = np.concatenate(
        [np.arange(a, b) for a, b in zip(starts, ends)])
    bounds = np.concatenate(
        [[0], np.cumsum(ends - starts)]).astype(np.int64)
    return CompiledTrace.from_columns(
        trace.kinds[idx], trace.durs[idx], bounds)


def _apportion(total: int, weights: np.ndarray) -> np.ndarray:
    """Integer shares of ``total`` proportional to ``weights`` (largest
    remainder; ties to lower index), summing exactly to ``total``."""
    w = np.asarray(weights, dtype=np.float64)
    s = w.sum()
    if s <= 0:
        raise ValueError("cannot apportion over all-zero weights")
    quota = total * w / s
    base = np.floor(quota).astype(np.int64)
    rem = int(total - base.sum())
    order = np.argsort(-(quota - base), kind="stable")
    base[order[:rem]] += 1
    return base


# -- plan --------------------------------------------------------------------


@dataclass(frozen=True)
class ClusterPlan:
    """Everything a cluster sweep derives once from (trace, keys, spec):
    per-op node assignment, per-node sub-traces/configs/op budgets, and
    (open loop) the routed per-node arrival streams."""

    spec: ClusterSpec
    assignment: np.ndarray            # node of each trace op, stream order
    node_traces: tuple                # CompiledTrace | None per node
    node_cfgs: tuple                  # SimConfig per node
    node_ops: tuple                   # measured ops per node (sum == n_ops)
    node_shares: tuple                # trace-op fraction per node
    node_arrivals: tuple              # np.ndarray | None per node
    node_deadline: float              # node-frame SLA deadline (0 = off)

    @property
    def active(self) -> tuple:
        """Node indices that serve at least one measured op."""
        return tuple(k for k, n in enumerate(self.node_ops) if n > 0)


def _node_arrival_need(cfg: SimConfig, candidates, warmup_ops,
                       node_ops: int) -> int:
    """Arrival timestamps node cells may consume (the plain sweep's widest-
    cell formula, with this node's measured-op budget)."""
    return max(
        cfg.n_cores * c
        + (warmup_ops if warmup_ops is not None else 2 * c * cfg.n_cores)
        + node_ops
        for c in candidates) + 1


def build_plan(
    cfg: SimConfig,
    trace: CompiledTrace,
    keys,
    is_write,
    spec: ClusterSpec,
    n_ops: int,
    warmup_ops: int | None,
    thread_candidates: Sequence[int],
    arrival: ArrivalSpec | None = None,
) -> ClusterPlan:
    """Partition one single-host experiment into per-node pieces.

    ``keys`` / ``is_write`` align 1:1 with ``trace``'s ops in stream order
    (the post-warmup slice of the workload that produced the trace).
    """
    keys = np.asarray(keys)
    if len(keys) != trace.n_ops:
        raise ValueError(
            f"keys has {len(keys)} entries but the trace has "
            f"{trace.n_ops} ops; pass the post-warmup workload slice")
    n_keys = int(keys.max()) + 1 if len(keys) else 1
    assignment = assign_ops(keys, is_write, spec, n_keys)
    counts = np.bincount(assignment, minlength=spec.n_nodes)

    node_traces = tuple(
        _subtrace(trace, assignment == k) for k in range(spec.n_nodes))
    node_cfgs = tuple(
        spec.node_config(cfg, k) for k in range(spec.n_nodes))
    node_ops = tuple(int(v) for v in _apportion(n_ops, counts))
    node_shares = tuple(float(c) / len(assignment) for c in counts)

    deadline = arrival.deadline if arrival is not None else 0.0
    l_route = spec.L_route
    node_deadline = 0.0
    if deadline > 0.0:
        node_deadline = deadline - l_route
        if node_deadline <= 0.0:
            raise ValueError(
                f"deadline ({deadline}s) must exceed the route hop "
                f"({l_route}s); every op would miss")

    node_arrivals: list = [None] * spec.n_nodes
    if arrival is not None:
        n_trace = trace.n_ops
        # Client-stream length so every active node receives the arrivals
        # its widest cell may consume (client arrival i routes to
        # assignment[i % n_trace]); with one node this is exactly the
        # plain sweep's stream.
        n_client = 0
        for k in range(spec.n_nodes):
            if node_ops[k] == 0 or counts[k] == 0:
                continue
            need_k = _node_arrival_need(node_cfgs[k], thread_candidates,
                                        warmup_ops, node_ops[k])
            pos = np.flatnonzero(assignment == k)
            full, rem = divmod(need_k, len(pos))
            if rem == 0:
                length = (full - 1) * n_trace + int(pos[-1]) + 1
            else:
                length = full * n_trace + int(pos[rem - 1]) + 1
            n_client = max(n_client, length)
        arr = generate_arrivals(arrival, n_client)
        stream_nodes = assignment[np.arange(n_client) % n_trace]
        for k in range(spec.n_nodes):
            if node_ops[k] == 0 or counts[k] == 0:
                continue
            node_arr = arr[stream_nodes == k]
            node_arrivals[k] = node_arr + l_route if l_route else node_arr

    return ClusterPlan(
        spec=spec,
        assignment=assignment,
        node_traces=node_traces,
        node_cfgs=node_cfgs,
        node_ops=node_ops,
        node_shares=node_shares,
        node_arrivals=tuple(node_arrivals),
        node_deadline=node_deadline,
    )


# -- sweep -------------------------------------------------------------------


@dataclass(frozen=True)
class NodeCell:
    """One node's contribution to a winning operating point (client frame:
    ``summary`` percentiles include the route hop)."""

    node: int
    share: float                  # fraction of the op stream it serves
    n_ops: int                    # measured ops it simulated
    throughput: float             # ops/sec (0 for idle nodes)
    time: float                   # virtual seconds of its run
    missed: int
    summary: LatencySummary | None


@dataclass
class ClusterPoint(SweepPoint):
    """A :class:`~repro_torch.core.sim.sweep.SweepPoint` whose ``result`` is the
    fleet aggregate, carrying the per-node breakdown."""

    nodes: tuple = ()


def _shift_summary(s: LatencySummary | None,
                   d: float) -> LatencySummary | None:
    """Move a node-frame summary to the client frame (+route hop)."""
    if s is None or d == 0.0 or s.count == 0:
        return s
    return dataclasses.replace(
        s, p50=s.p50 + d, p90=s.p90 + d, p99=s.p99 + d, max=s.max + d)


def _classify(op_latencies, deadline: float) -> tuple[list, int]:
    """Split measured sojourns into (kept, missed) with the loops' exact
    rule, so host-side fleet merging matches the cells' own summaries."""
    if deadline <= 0.0:
        return list(op_latencies), 0
    kept, missed = [], 0
    for v in op_latencies:
        if v > deadline:
            missed += 1
        else:
            kept.append(v)
    return kept, missed


def sweep_cluster(
    cfg: SimConfig,
    trace: CompiledTrace,
    keys,
    is_write,
    spec: ClusterSpec,
    latencies: Iterable,
    thread_candidates: Sequence[int],
    n_ops: int = 5000,
    warmup_ops: int | None = None,
    backend: str = "torch",
    collect_latency: bool = False,
    collect_percentiles: bool = False,
    arrival: ArrivalSpec | dict | None = None,
    device=None,
    use_kernel: bool | None = None,
    substeps: int | None = None,
    host_devices: int | None = None,
) -> list[ClusterPoint]:
    """Throughput vs. memory latency for a sharded fleet.

    The cluster analogue of :func:`~repro_torch.core.sim.sweep_latency`: every
    (latency, thread count) cell runs once *per node* (each node gets its
    sub-trace, config, measured-op share, and routed arrivals from
    :func:`build_plan`), the fleet throughput at a cell is the sum of node
    throughputs, and the per-latency winner is the thread count -- applied
    fleet-wide -- with the highest fleet throughput (first candidate wins
    ties).  ``backend`` selects how node cells execute: the compiled loop
    (``"loop"``), the generic event loop (``"generic"``, the equivalence
    harness), or the device grid (``"torch"``, the default: one
    :func:`~repro_torch.core.sim.replay_torch.sweep_grid` per active node,
    one after another; mixture latencies fall back to the compiled loop per
    cell, like the plain sweep).  ``device`` / ``use_kernel`` /
    ``substeps`` / ``host_devices`` are passed to every node's
    ``sweep_grid`` unchanged (``device=None`` means the CUDA device and
    raises without one).

    Returns one :class:`ClusterPoint` per latency: ``result`` aggregates
    the fleet (throughput summed, makespan time, fleet-merged tail
    summary), ``nodes`` holds each node's :class:`NodeCell` in node order
    (idle nodes included, with zero ops).  All reported latency summaries
    are in the client frame (route hop included).
    """
    if backend not in CLUSTER_BACKENDS:
        raise ValueError(
            f"backend must be one of {CLUSTER_BACKENDS}, got {backend!r}")
    latencies = list(latencies)
    candidates = list(thread_candidates)
    if not latencies or not candidates:
        return []
    if backend == "torch" and collect_latency:
        raise ValueError(
            "per-op latency collection is only available from the loop "
            "backends")
    arrival_spec = None
    if arrival is not None:
        arrival_spec = (arrival if isinstance(arrival, ArrivalSpec)
                        else ArrivalSpec.from_dict(dict(arrival)))

    plan = build_plan(cfg, trace, keys, is_write, spec, n_ops, warmup_ops,
                      candidates, arrival_spec)
    l_route = spec.L_route
    active = plan.active
    if not active:
        raise ValueError("no node serves any measured op")
    # Fleet merging needs raw sojourns from every exactly-merged cell
    # (loop/generic cells, and the torch backend's mixture-latency
    # fallback cells -- run_loop_cell only ever runs those).
    want_raw = collect_percentiles

    def run_loop_cell(k: int, L, c: int) -> SimResult:
        cfg_c = replace(plan.node_cfgs[k], L_mem=L, n_threads=c)
        kw = dict(arrivals=plan.node_arrivals[k],
                  collect_percentiles=collect_percentiles,
                  deadline=plan.node_deadline)
        if backend == "generic":
            return simulate(cfg_c, plan.node_traces[k].as_source(),
                            plan.node_ops[k], warmup_ops,
                            collect_latency or want_raw, **kw)
        return simulate_compiled(cfg_c, plan.node_traces[k],
                                 plan.node_ops[k], warmup_ops,
                                 collect_latency or want_raw, **kw)

    # cells[k][li][ci] -> SimResult; grids[k] -> (GridResult, {li: row})
    # for torch nodes (scalar-latency rows come from the grid call).
    cells: dict = {}
    grids: dict = {}
    scalar_lis = [li for li, L in enumerate(latencies)
                  if isinstance(L, numbers.Real)]
    for k in active:
        if backend == "torch":
            from .sim import replay_torch   # deferred: heavyweight import

            row_of = {}
            grid = None
            if scalar_lis:
                grid = replay_torch.sweep_grid(
                    plan.node_cfgs[k], plan.node_traces[k],
                    [latencies[li] for li in scalar_lis], candidates,
                    plan.node_ops[k], warmup_ops,
                    arrivals=plan.node_arrivals[k],
                    collect_percentiles=collect_percentiles,
                    deadline=plan.node_deadline, device=device,
                    use_kernel=use_kernel, substeps=substeps,
                    host_devices=host_devices)
                row_of = {li: r for r, li in enumerate(scalar_lis)}
            grids[k] = (grid, row_of)
            cells[k] = [
                [grid.result(row_of[li], ci) if li in row_of
                 else run_loop_cell(k, latencies[li], candidates[ci])
                 for ci in range(len(candidates))]
                for li in range(len(latencies))
            ]
        else:
            cells[k] = [
                [run_loop_cell(k, L, c) for c in candidates]
                for L in latencies
            ]

    points: list[ClusterPoint] = []
    for li, L in enumerate(latencies):
        fleet_thr = [
            sum(cells[k][li][ci].throughput for k in active)
            for ci in range(len(candidates))
        ]
        best = min(range(len(candidates)),
                   key=lambda ci: (-fleet_thr[ci], ci))

        node_cells = []
        fleet_summary = None
        use_hist = backend == "torch" and li in scalar_lis
        if collect_percentiles:
            if use_hist:
                hist = None
                vmax = float("nan")
                missed_total = 0
                for k in active:
                    grid, row_of = grids[k]
                    row = row_of[li]
                    h = grid.lat_hist[row, best]
                    hist = h if hist is None else hist + h
                    m = grid.lat_max[row, best]
                    if not np.isnan(m):
                        vmax = m if np.isnan(vmax) else max(vmax, float(m))
                    missed_total += int(grid.missed[row, best])
                fleet_summary = _shift_summary(
                    summarize_hist(hist, vmax, missed_total), l_route)
            else:
                kept_all: list = []
                missed_total = 0
                for k in active:
                    kept, missed = _classify(
                        cells[k][li][best].op_latencies,
                        plan.node_deadline)
                    kept_all.extend(kept)
                    missed_total += missed
                fleet_summary = _shift_summary(
                    summarize_exact(kept_all, missed_total), l_route)

        for k in range(spec.n_nodes):
            if k not in cells:
                node_cells.append(NodeCell(
                    node=k, share=plan.node_shares[k], n_ops=0,
                    throughput=0.0, time=0.0, missed=0, summary=None))
                continue
            r = cells[k][li][best]
            node_cells.append(NodeCell(
                node=k, share=plan.node_shares[k],
                n_ops=plan.node_ops[k], throughput=r.throughput,
                time=r.time, missed=r.missed_ops,
                summary=_shift_summary(r.latency_summary, l_route)))

        winners = [cells[k][li][best] for k in active]
        op_lats: list = []
        if collect_latency and backend != "torch":
            for r in winners:
                if l_route:
                    op_lats.extend(v + l_route for v in r.op_latencies)
                else:
                    op_lats.extend(r.op_latencies)
        fleet = SimResult(
            ops=sum(plan.node_ops[k] for k in active),
            time=max(r.time for r in winners),
            throughput=sum(r.throughput for r in winners),
            mem_stall_total=sum(r.mem_stall_total for r in winners),
            mem_accesses=sum(r.mem_accesses for r in winners),
            op_latencies=op_lats,
            missed_ops=sum(r.missed_ops for r in winners),
            latency_summary=fleet_summary,
        )
        points.append(ClusterPoint(
            L_mem=L,
            n_threads=candidates[best],
            result=fleet,
            per_thread={candidates[ci]: fleet_thr[ci]
                        for ci in range(len(candidates))},
            nodes=tuple(node_cells),
        ))
    return points
