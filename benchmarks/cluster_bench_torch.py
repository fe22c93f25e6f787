#!/usr/bin/env python
"""Benchmark: sharded-fleet scenarios through ``repro_torch.core.cluster``.

The PyTorch / CUDA port's counterpart of ``benchmarks/cluster_bench.py``:
the same four scenarios, sizes and protocol, with every node's cells
replayed by the port's device grid (``--backend torch``, on ``--device``,
default ``cuda``; without a card it raises, nothing falls back to the
CPU) or by its host loop (``--backend loop``).  It imports torch, numpy
and the port, never the reference package.

The single-host benches measure one node.  This bench runs the three
fleet situations a sharded SSD-backed KV service actually meets, on the
cluster pipeline (``Scenario.cluster`` -> ``sweep_cluster``), and records
per-node *and* fleet-wide tails under open-loop load:

``hot_shard`` / ``hot_shard_drift``
    Zipf mass concentrates on whichever shard owns the hottest keys (the
    drift variant sharpens the skew across the op stream via the
    ``drifting-zipf`` workload).  Replication 2 with the ``spread`` read
    policy shows replicas absorbing part of the hot shard's read load.
``degraded_node``
    One node's SSD clocks slow mid-run (``io_degrade`` onset at
    ``T_degrade_us``): its tail detaches from the healthy nodes' while
    the fleet percentiles blend both populations.
``migration``
    A shard handover under load: at ``at_frac`` of the op stream, shard
    0's ops start executing on node 2, which then serves two shards.

Protocol, per scenario: a closed-loop capacity probe (lowest-latency
fleet throughput at the suite thread count) fixes ``C``; one open-loop
Poisson sweep at ``LOAD_FRAC x C`` with ``collect_percentiles=True``
produces the entries.  Both phases run through the public
:class:`~repro_torch.core.experiment.Experiment` API, so this bench also
exercises the ``Scenario.cluster`` wiring end to end.

Measurements land in JSON (schema ``repro.cluster_bench/v1``, validated
unchanged by ``tools/check_bench.py``: fleet and per-node achieved <=
offered, ordered fleet percentiles, shares summing to 1, and the
degraded-node entry present), by default in
``chiprun_out/cluster_bench_torch.json``::

    PYTHONPATH=src python -m benchmarks.cluster_bench_torch
    python tools/check_bench.py chiprun_out/cluster_bench_torch.json

``--smoke`` shrinks traces and op counts to a seconds-scale slice (same
schema); ``--scenario NAME`` restricts to one scenario.  On the torch
backend fleet tails come from merged log-histograms (``source:
"hist"``); the ``host`` block also names the device, and each scenario's
summary carries its wall seconds (``wall_s``).
"""
from __future__ import annotations

import argparse
import json
import os
import platform
import sys
import time
from pathlib import Path

SCHEMA = "repro.cluster_bench/v1"
US = 1e-6
OUT = Path(__file__).resolve().parents[1] / "chiprun_out" / \
    "cluster_bench_torch.json"

#: Offered load as a fraction of the probed fleet capacity.
LOAD_FRAC = 0.7

FULL_SIZE = dict(n_keys=30_000, n_wl_ops=12_000, n_ops=4000,
                 latencies_us=(0.5, 2.0, 5.0, 8.0),
                 thread_candidates=(8, 16))
SMOKE_SIZE = dict(n_keys=4_000, n_wl_ops=2_000, n_ops=800,
                  latencies_us=(1.0, 5.0), thread_candidates=(16,))

#: Every fleet scenario routes through a 4-node hash-partitioned cluster
#: behind a 5 us router hop; the scenarios differ in workload skew and
#: per-node state.
N_NODES = 4
L_ROUTE_US = 5.0


def _scenario(name: str, smoke: bool, workload: str, workload_kwargs: dict,
              cluster_extra: dict | None = None):
    from repro_torch.core.experiment import Scenario

    size = SMOKE_SIZE if smoke else FULL_SIZE
    cluster = dict(n_nodes=N_NODES, partition="hash",
                   L_route_us=L_ROUTE_US, **(cluster_extra or {}))
    return Scenario(
        engine="hash-index", engine_kwargs={"seed": 6},
        workload=workload, workload_kwargs=workload_kwargs,
        cluster=cluster, name=name, seed=7, P=12, **size)


def hot_shard(smoke: bool):
    """Static Zipf skew; replication 2 + spread reads shave the hot shard."""
    return _scenario(
        "hot_shard", smoke, "zipf",
        {"exponent": 1.2, "read_write": (1, 0), "seed": 3},
        {"replication": 2, "replica_policy": "spread"})


def hot_shard_drift(smoke: bool):
    """Skew sharpening over the op stream (drifting-zipf), primary reads."""
    return _scenario(
        "hot_shard_drift", smoke, "drifting-zipf",
        {"exponent0": 0.6, "exponent1": 1.4, "read_write": (1, 0),
         "seed": 3})


def degraded_node(smoke: bool):
    """Node 1's SSD clocks slow 4x partway into each cell's virtual run."""
    t_degrade_us = 1_000.0 if smoke else 4_000.0
    return _scenario(
        "degraded_node", smoke, "uniform",
        {"read_write": (1, 0), "seed": 2},
        {"node_overrides": {
            "1": {"io_degrade": 4.0, "T_degrade_us": t_degrade_us}}})


def migration(smoke: bool):
    """Shard 0 hands over to node 2 at 50% of the op stream, under load."""
    return _scenario(
        "migration", smoke, "zipf",
        {"exponent": 1.1, "read_write": (1, 0), "seed": 3},
        {"migrate": {"shard": 0, "to": 2, "at_frac": 0.5}})


#: name -> make(smoke) for every fleet scenario this bench ships (the same
#: four as ``benchmarks/cluster_bench.py``).
SCENARIOS = {
    "hot_shard": hot_shard,
    "hot_shard_drift": hot_shard_drift,
    "degraded_node": degraded_node,
    "migration": migration,
}


def _degraded_nodes(scenario) -> set[int]:
    return {int(k) for k, ov in scenario.cluster.get(
        "node_overrides", {}).items()
        if float(ov.get("io_degrade", 1.0)) != 1.0}


def _tail_us(tail: dict, field: str) -> float | None:
    v = tail[field]
    return None if v is None else round(v, 3)


def run_scenario(name: str, smoke: bool, backend: str, device="cuda",
                 offer_of: float | None = None) -> dict:
    """One scenario's probe and open-loop sweep.  ``offer_of`` replaces the
    probed capacity as the base of the offered rate (the probe still runs
    and is reported), so two backends can be compared at one offered
    load."""
    import dataclasses

    from repro_torch.core.experiment import Experiment, RunOptions

    t0 = time.perf_counter()
    scenario = SCENARIOS[name](smoke)
    probe = Experiment(scenario, RunOptions(backend=backend,
                                            device=device)).run()
    capacity = float(probe.rows[0].throughput)
    rate = LOAD_FRAC * (capacity if offer_of is None else offer_of)
    print(f"# {name}: fleet capacity {capacity / 1e3:.1f} kops/s at "
          f"L={scenario.latencies_us[0]}us -> offering {LOAD_FRAC:.0%}",
          file=sys.stderr, flush=True)

    open_sc = dataclasses.replace(
        scenario, arrival={"kind": "poisson", "rate": rate, "seed": 11})
    art = Experiment(
        open_sc, RunOptions(backend=backend, device=device,
                            collect_percentiles=True),
    ).run()
    wall_s = time.perf_counter() - t0

    degraded = _degraded_nodes(scenario)
    migrate = bool(scenario.cluster.get("migrate"))
    entries = []
    for row in art.rows:
        t = row.tail
        # Fleet achieved load = completed ops / fleet makespan (the fleet
        # is done when its slowest node is).  The artifact's fleet
        # throughput sums per-node rates, which overstates the open-loop
        # rate when migration time-concentrates a node's window.
        active = [nd for nd in row.nodes if nd["n_ops"] > 0]
        achieved = (sum(nd["n_ops"] for nd in active)
                    / max(nd["time"] for nd in active))
        nodes = []
        for nd in row.nodes:
            nt = nd["tail"]
            nodes.append({
                "node": nd["node"],
                "share": round(nd["share"], 6),
                "degraded": nd["node"] in degraded,
                "n_ops": nd["n_ops"],
                "offered_load": round(nt["offered_load"], 1),
                "achieved_load": round(nd["throughput"], 1),
                "p50_us": _tail_us(nt, "p50_us"),
                "p90_us": _tail_us(nt, "p90_us"),
                "p99_us": _tail_us(nt, "p99_us"),
                "max_us": _tail_us(nt, "max_us"),
                "count": nt["count"], "missed": nt["missed"],
            })
        entries.append({
            "name": name, "engine": scenario.engine, "backend": backend,
            "n_nodes": N_NODES, "L_us": row.L_us,
            "n_threads": row.n_threads, "n_ops": scenario.n_ops,
            "migrate": migrate,
            "offered_frac": LOAD_FRAC,
            "offered_load": round(rate, 1),
            "achieved_load": round(achieved, 1),
            "p50_us": _tail_us(t, "p50_us"),
            "p90_us": _tail_us(t, "p90_us"),
            "p99_us": _tail_us(t, "p99_us"),
            "max_us": _tail_us(t, "max_us"),
            "count": t["count"], "missed": t["missed"],
            "miss_rate": round(t["miss_rate"], 6),
            "source": t["source"],
            "nodes": nodes,
        })
    lo, hi = entries[0], entries[-1]
    hot = max(entries[0]["nodes"], key=lambda n: n["share"])
    print(f"# {name}: fleet P99 {lo['p99_us']:.1f}us @ {lo['L_us']}us ... "
          f"{hi['p99_us']:.1f}us @ {hi['L_us']}us "
          f"(hottest shard: node {hot['node']} at {hot['share']:.0%})",
          file=sys.stderr, flush=True)
    return {
        "capacity": round(capacity, 1),
        "entries": entries,
        "summary": {
            "capacity": round(capacity, 1),
            "offered_frac": LOAD_FRAC,
            "n_points": len(entries),
            "n_nodes": N_NODES,
            "hottest_share": hot["share"],
            "degraded_nodes": sorted(degraded),
            "migrate": migrate,
            "wall_s": wall_s,
        },
    }


def _device_name(backend: str, device) -> str:
    if backend != "torch":
        return "host"
    import torch

    from repro_torch.core.sim.replay_torch import resolve_device

    dev = resolve_device(device)
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def run(names, smoke: bool, backend: str, device="cuda",
        offer_of: dict | None = None) -> dict:
    """The measurement document of ``names`` (``offer_of``: scenario name
    -> the capacity its offered rate is taken from, see
    :func:`run_scenario`)."""
    host_device = _device_name(backend, device)
    entries, summary = [], {}
    for name in names:
        res = run_scenario(name, smoke, backend, device,
                           (offer_of or {}).get(name))
        entries += res["entries"]
        summary[name] = res["summary"]
    return {
        "schema": SCHEMA,
        "host": {
            "platform": platform.platform(),
            "machine": platform.machine(),
            "cpu_count": os.cpu_count(),
            "python": platform.python_version(),
            "device": host_device,
        },
        "backend": backend,
        "smoke": bool(smoke),
        "entries": entries,
        "summary": summary,
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="seconds-scale CI slice (small traces, 800 ops)")
    ap.add_argument("--scenario", default=None, choices=sorted(SCENARIOS),
                    help="run one fleet scenario (default: all)")
    ap.add_argument("--backend", default="torch", choices=("torch", "loop"),
                    help="per-node cell backend (default torch: the device "
                         "grid, fleet tails from merged log-histograms; "
                         "loop: exact fleet percentiles)")
    ap.add_argument("--device", default="cuda",
                    help="device of the torch backend (default cuda; cpu "
                         "runs the plain step on the host)")
    ap.add_argument("--out", default=str(OUT), metavar="OUT.json",
                    help=f"write the measurement JSON here (default: {OUT})")
    args = ap.parse_args(argv)

    names = [args.scenario] if args.scenario else sorted(SCENARIOS)
    doc = run(names, args.smoke, args.backend, args.device)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(doc, indent=2) + "\n")
    print(f"# wrote {out}", file=sys.stderr)


if __name__ == "__main__":
    main()
