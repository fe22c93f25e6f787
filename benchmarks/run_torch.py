# One function per paper table/figure. Prints ``name,us_per_call,derived`` CSV.
"""Benchmark harness entry point of the PyTorch / CUDA port.

The counterpart of ``benchmarks/run.py`` over :mod:`repro_torch`: the same
CSV format, flags and argument checks, with sweeps on the port's backends.

``python -m benchmarks.run_torch``      -- paper figures + the kernels'
                                           measured rows (on the card)
``python -m benchmarks.run_torch --only fig11``
``python -m benchmarks.run_torch --only fig11 --backend loop --processes 4``
``python -m benchmarks.run_torch --scenario examples/scenarios/hash_index_2ssd.json``
                                        -- one declarative scenario through
                                           the public experiment API
``python -m benchmarks.run_torch --suite examples/scenarios``
                                        -- every scenario spec in a directory
                                           as one suite matrix, written to
                                           ``BENCH_<dirname>.json`` for
                                           baseline diffing with
                                           ``tools/artifact_diff.py``
``python -m benchmarks.run_torch --engine hash_index --devices 2``
                                        -- sugar: builds the default matrix
                                           scenario for one engine on N SSDs
``python -m benchmarks.run_torch --list-engines``  / ``--list-workloads``
                                        -- canonical registry names valid in
                                           scenario specs

``--backend torch`` (the default) replays every scalar-latency grid of a
sweep on ``--device`` (default ``cuda``) through the fused CUDA scheduler
kernel; ``--backend loop`` is the caller asking for the host interpreter
(the reference CLI's default).  Without a CUDA device a torch-backend run
exits non-zero before any work and names ``--device cpu`` (the plain
PyTorch step on the host) and ``--backend loop``; the ``--list-*`` flags
need no card.  ``--backend-substeps K`` sets the scheduler steps per kernel
launch (``RunOptions.substeps``); ``--backend-host-devices N`` splits each
cohort's grid cells into N shards, one per CUDA device (``RunOptions.
host_devices``; on ``--device cpu`` one after another on the host).  The
reference's ``--backend-pallas`` and ``--backend-unroll`` have no
counterpart here and are refused.  ``--processes`` sets the worker-process count of a
loop grid, ``--sweep-cache`` memoizes finished sweep cells on disk (keyed
by backend and a code-version salt), ``--adaptive`` warm-starts the
per-point thread search (loop backend only).  ``--artifact`` writes the
scenario run's full :class:`~repro_torch.core.experiment.RunArtifact` as
JSON.  ``--arrival KIND --rate OPS_PER_S`` (optionally ``--burst FRAC``)
switches a scenario/engine sweep to an open-loop arrival process with
per-cell sojourn tail percentiles; ``--nodes N`` (optionally
``--replicas R``, ``--route-latency US``) shards it across an N-node
cluster (:class:`~repro_torch.core.cluster.ClusterSpec`), and
``--list-cluster-scenarios`` prints the fleet scenarios of
``benchmarks.cluster_bench_torch``.  ``--engine`` accepts any name or alias
in the ``repro_torch.core.engines`` registry; ``--devices`` sets the
simulated SSD count and ``--cores`` the simulated host CPU core count.

The default bench list is ``paper_figs_torch.ALL`` followed by
``kernels_bench_torch.ALL`` (flash, paged and wkv6 measured on the card;
left out with ``--device cpu``, which one CSV row says) and
``roofline_table_torch`` (the dry run's roofline terms, read from
``experiments/dryrun_torch``).  This module
imports torch, numpy and the port, never ``jax`` or the reference package.
"""
from __future__ import annotations

import argparse
import sys
import time
import traceback


def _list_registry(kind: str) -> None:
    """Print canonical registry names, one per line (aliases omitted --
    these are the values valid in scenario specs)."""
    if kind == "engines":
        from repro_torch.core.engines import available_engines

        names = sorted({cls.engine_name for cls in
                        available_engines().values()})
    else:
        from repro_torch.core.workloads import available_workloads

        names = sorted({fn.workload_name for fn in
                        available_workloads().values()})
    for name in names:
        print(name)


def emit_artifact(art, prefix: str) -> None:
    """Print one scenario artifact in the benchmark CSV row format."""
    from . import common_torch as common

    base = art.baseline_throughput
    for row in art.rows:
        derived = (f"norm={row.throughput / base:.4f};"
                   f"threads={row.n_threads};"
                   f"model_kops={row.model_throughput / 1e3:.1f}")
        if row.mean_op_latency_us is not None:
            derived += f";op_latency_us={row.mean_op_latency_us:.3f}"
        if row.tail is not None:
            t = row.tail
            if t["p99_us"] is not None:
                derived += (f";p50_us={t['p50_us']:.3f}"
                            f";p99_us={t['p99_us']:.3f}")
            derived += f";miss_rate={t['miss_rate']:.4f}"
            if t["offered_load"] is not None:
                derived += (f";offered_kops={t['offered_load'] / 1e3:.1f}"
                            f";achieved_kops={t['achieved_load'] / 1e3:.1f}")
        if row.nodes is not None:
            hot = max(row.nodes, key=lambda n: n["share"])
            derived += (f";nodes={len(row.nodes)}"
                        f";hot_node={hot['node']}"
                        f";hot_share={hot['share']:.2f}")
        common.emit(f"{prefix}/{row.label()}", 1e6 / row.throughput, derived)
    last = art.rows[-1]
    common.emit(
        f"{prefix}/summary",
        0.0,
        f"degradation_at_{last.label()[1:]}="
        f"{1 - last.throughput / base:.4f};"
        f"S={art.S:.3f};M={art.M:.2f}",
    )


def run_scenario_cmd(scenario, artifact_out: str | None,
                     collect_latency: bool, adaptive: bool,
                     backend: str = "torch",
                     prefix: str | None = None,
                     backend_opts: dict | None = None,
                     arrival: dict | None = None,
                     cluster: dict | None = None) -> None:
    """Execute one scenario through the public experiment API.

    ``backend_opts`` are torch-backend fields of
    :class:`~repro_torch.core.experiment.RunOptions` (``device``,
    ``substeps``).  ``arrival`` (an
    :class:`~repro_torch.core.sim.ArrivalSpec` dict from
    ``--arrival/--rate/--burst``) overrides the scenario's arrival process and
    switches on per-cell tail percentiles; ``cluster`` (a partial
    :class:`~repro_torch.core.cluster.ClusterSpec` dict from
    ``--nodes/--replicas/--route-latency``) overlays the scenario's
    fleet shape."""
    import dataclasses as _dc

    from repro_torch.core.experiment import Experiment

    from . import common_torch as common

    try:
        if arrival is not None:
            scenario = _dc.replace(scenario, arrival=arrival)
        if cluster is not None:
            scenario = _dc.replace(
                scenario, cluster={**dict(scenario.cluster), **cluster})
        # an open-loop run without tail stats is useless -- collect them
        collect_percentiles = bool(scenario.arrival)
        # display_name resolves the engine too: unknown names fail here,
        # before the (expensive) run, with the registry listing
        prefix = prefix or f"scenario/{scenario.display_name}"
        art = Experiment(
            scenario,
            common.run_options(collect_latency=collect_latency,
                               adaptive=adaptive, backend=backend,
                               collect_percentiles=collect_percentiles,
                               **(backend_opts or {})),
        ).run()
    except KeyError as e:  # unknown engine/workload: resolution is lazy and
        sys.exit(str(e.args[0]) if e.args else str(e))  # lists what exists
    except ValueError as e:  # e.g. incompatible --backend combination
        sys.exit(str(e))
    emit_artifact(art, prefix)
    if artifact_out:
        with open(artifact_out, "w") as f:
            f.write(art.to_json())
        print(f"{prefix}/artifact,0.0000,wrote={artifact_out}",
              file=sys.stderr)


def run_suite_cmd(suite_dir: str, out_path: str | None,
                  collect_latency: bool, adaptive: bool,
                  backend: str = "torch",
                  backend_opts: dict | None = None) -> None:
    """Sweep a directory of scenario specs as one suite matrix.

    Every ``*.json`` in ``suite_dir`` is a :class:`Scenario` spec; the
    suite document (``BENCH_<dirname>.json`` by default, schema
    ``repro.scenario_suite/v1`` with its ``backend`` field, as the
    reference writes it) carries a shared ``index`` (one summary entry per
    scenario) plus per-scenario ``rows`` under ``artifacts``, in the shape
    ``tools/artifact_diff.py`` compares suite-wise against a baseline.  On
    the loop backend the rows are machine-independent and equal to the
    reference CLI's; on the torch backend they agree with the loop's within
    the backend contract (``repro_torch.core.conformance``).
    """
    import json
    import os
    import platform
    from pathlib import Path

    from repro_torch.core.experiment import Experiment, Scenario

    from . import common_torch as common

    d = Path(suite_dir)
    paths = sorted(d.glob("*.json"))
    if not paths:
        sys.exit(f"no *.json scenario specs in {suite_dir!r}")
    suite = d.name or "suite"
    artifacts: dict = {}
    index: list = []
    t_suite = time.time()
    for path in paths:
        try:
            spec = Scenario.from_json(path.read_text())
        except (OSError, ValueError, TypeError, KeyError) as e:
            sys.exit(f"bad scenario spec {str(path)!r}: {e}")
        name = path.stem
        t0 = time.time()
        try:
            art = Experiment(
                spec,
                common.run_options(
                    collect_latency=collect_latency, adaptive=adaptive,
                    backend=backend,
                    collect_percentiles=bool(spec.arrival),
                    **(backend_opts or {})),
            ).run()
        except (KeyError, ValueError) as e:
            sys.exit(f"scenario {name!r}: {e.args[0] if e.args else e}")
        wall = time.time() - t0
        emit_artifact(art, f"suite/{suite}/{name}")
        rows = json.loads(art.to_json())["rows"]
        artifacts[name] = {"rows": rows}
        cl = spec.cluster_spec()
        index.append({
            "scenario": name,
            "file": path.name,
            "engine": art.engine,
            "workload": art.workload,
            "n_rows": len(rows),
            "arrival": (dict(spec.arrival).get("kind", "closed")
                        if spec.arrival else "closed"),
            "cluster_nodes": cl.n_nodes if cl is not None else 1,
            "wall_s": round(wall, 3),
        })
    doc = {
        "schema": "repro.scenario_suite/v1",
        "suite": suite,
        "backend": backend,
        "host": {
            "platform": platform.platform(),
            "machine": platform.machine(),
            "cpu_count": os.cpu_count(),
            "python": platform.python_version(),
        },
        "index": index,
        "artifacts": artifacts,
        "summary": {
            "n_scenarios": len(index),
            "total_rows": sum(e["n_rows"] for e in index),
            "total_wall_s": round(time.time() - t_suite, 3),
        },
    }
    out = out_path or f"BENCH_{suite}.json"
    with open(out, "w") as f:
        json.dump(doc, f, indent=2)
        f.write("\n")
    print(f"suite/{suite}/artifact,0.0000,wrote={out}", file=sys.stderr)


def _benches(device) -> list:
    """The default bench list: the paper's figures, then the kernels'
    measured rows (which need the card: left out on ``--device cpu``), then
    the dry run's roofline table."""
    from . import paper_figs_torch, roofline_table_torch

    benches = [(f.__name__, f) for f in paper_figs_torch.ALL]
    import torch

    if torch.device(device).type == "cpu":
        def kernels_left_out():
            print("kernels/all,0.0000,left_out=device cpu: the kernel rows "
                  "are measured on the card")
        benches.append(("kernels_bench_torch", kernels_left_out))
    else:
        from . import kernels_bench_torch

        benches += [(f.__name__, f) for f in kernels_bench_torch.ALL]
    benches.append(("roofline_table", roofline_table_torch.main))
    return benches


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default="", help="substring filter on bench names")
    ap.add_argument("--processes", type=int, default=None,
                    help="worker processes for loop sweep grids (default: "
                         "cpu count)")
    ap.add_argument("--sweep-cache", default=None, metavar="DIR",
                    help="directory memoizing finished sweep cells "
                         "(e.g. .sweep_cache); cells are keyed by config, "
                         "trace, backend, and a code-version salt, so "
                         "cells from older code are never served")
    ap.add_argument("--sweep-cache-clear", action="store_true",
                    help="with --sweep-cache: delete every memoized cell "
                         "in the cache directory before running")
    ap.add_argument("--sweep-cache-prune", type=float, default=None,
                    metavar="MB",
                    help="with --sweep-cache: before running, evict "
                         "least-recently-used cells (mtime order; cache "
                         "hits refresh it) until the cache is at most MB "
                         "megabytes")
    ap.add_argument("--sweep-cache-prune-days", type=float, default=None,
                    metavar="D",
                    help="with --sweep-cache: before running, drop cells "
                         "not used in the last D days (combines with "
                         "--sweep-cache-prune)")
    ap.add_argument("--backend", default="torch", choices=("torch", "loop"),
                    help="sweep execution backend -- the 'torch' device "
                         "grid (default; tolerance-equivalent to the loop, "
                         "see docs/PORT.md) or the 'loop' host interpreter")
    ap.add_argument("--device", default="cuda",
                    help="device of the torch backend (default cuda; cpu "
                         "runs the plain PyTorch step on the host)")
    ap.add_argument("--backend-substeps", type=int, default=None,
                    metavar="K",
                    help="with --backend torch: scheduler steps per kernel "
                         "launch (must divide the uniform chunk of 1024; "
                         "default: sweep_grid's)")
    ap.add_argument("--backend-host-devices", type=int, default=None,
                    metavar="N",
                    help="with --backend torch: split each cohort's grid "
                         "cells into N shards, one per CUDA device "
                         "cuda:0..N-1 (bit-identical to one device; on "
                         "--device cpu the shards run one after another)")
    ap.add_argument("--scenario", default=None, metavar="SPEC.json",
                    help="run one declarative scenario spec through the "
                         "experiment API instead of the paper figures")
    ap.add_argument("--suite", default=None, metavar="DIR",
                    help="run every *.json scenario spec in DIR as one "
                         "suite matrix and write BENCH_<dirname>.json "
                         "(shared artifact index + per-scenario rows; "
                         "compare against a checked-in baseline with "
                         "tools/artifact_diff.py)")
    ap.add_argument("--suite-out", default=None, metavar="OUT.json",
                    help="with --suite: suite document path (default "
                         "BENCH_<dirname>.json in the working directory)")
    ap.add_argument("--artifact", default=None, metavar="OUT.json",
                    help="with --scenario/--engine: write the RunArtifact "
                         "(sweep table + provenance) as JSON")
    ap.add_argument("--collect-latency", action="store_true",
                    help="with --scenario/--engine: record per-op latencies "
                         "(bypasses the sweep cache; loop backend only)")
    ap.add_argument("--adaptive", action="store_true",
                    help="with --scenario/--engine: warm-started thread "
                         "search instead of the full grid (cells run "
                         "serially; loop backend only)")
    ap.add_argument("--arrival", default=None,
                    choices=("poisson", "bursty", "diurnal"),
                    help="with --scenario/--engine: drive the sweep "
                         "open-loop with this arrival process instead of "
                         "the closed loop (requires --rate; records "
                         "per-cell sojourn tail percentiles, see "
                         "docs/TAIL_LATENCY.md)")
    ap.add_argument("--rate", type=float, default=None, metavar="OPS_PER_S",
                    help="with --arrival: offered load in ops/sec "
                         "(time-average rate for bursty/diurnal)")
    ap.add_argument("--burst", type=float, default=None, metavar="FRAC",
                    help="with --arrival bursty: ON-state duty cycle in "
                         "(0, 1] (default 0.25; the ON rate is "
                         "rate / FRAC, so the time-average stays --rate)")
    ap.add_argument("--nodes", type=int, default=None, metavar="N",
                    help="with --scenario/--engine: shard the sweep over "
                         "an N-node hash-partitioned cluster behind a "
                         "router (per-node + fleet tails in the "
                         "artifact; see docs/CLUSTER.md)")
    ap.add_argument("--replicas", type=int, default=None, metavar="R",
                    help="with --nodes: replication factor with the "
                         "'spread' read policy (reads rotate over the "
                         "shard's replica set; default 1)")
    ap.add_argument("--route-latency", type=float, default=None,
                    metavar="US",
                    help="with --nodes: router hop in microseconds, paid "
                         "once inbound per op (default 0)")
    ap.add_argument("--engine", default=None, metavar="NAME",
                    help="sugar for --scenario: sweep one registered "
                         "engine's default matrix scenario (any registry "
                         "name/alias, e.g. hash_index)")
    ap.add_argument("--devices", type=int, default=1, metavar="N",
                    help="simulated SSD count for --engine (default 1)")
    ap.add_argument("--cores", type=int, default=1, metavar="N",
                    help="simulated host CPU cores for --engine "
                         "(default 1; thread candidates are per core)")
    ap.add_argument("--list-engines", action="store_true",
                    help="print canonical engine registry names and exit")
    ap.add_argument("--list-workloads", action="store_true",
                    help="print canonical workload registry names and exit")
    ap.add_argument("--list-cluster-scenarios", action="store_true",
                    help="print the named fleet scenarios shipped by "
                         "benchmarks.cluster_bench_torch and exit")
    args = ap.parse_args(argv)

    if args.list_engines:
        _list_registry("engines")
        return
    if args.list_workloads:
        _list_registry("workloads")
        return
    if args.list_cluster_scenarios:
        from .cluster_bench_torch import SCENARIOS

        for name in sorted(SCENARIOS):
            print(name)
        return

    from . import common_torch as common

    common.SWEEP_PROCESSES = args.processes
    common.SWEEP_CACHE = args.sweep_cache
    common.BACKEND = args.backend
    common.DEVICE = args.device

    if args.sweep_cache_clear:
        if args.sweep_cache is None:
            sys.exit("--sweep-cache-clear requires --sweep-cache DIR")
        from repro_torch.core.sim import clear_sweep_cache

        removed = clear_sweep_cache(args.sweep_cache)
        print(f"sweep-cache: cleared {removed} cell(s) from "
              f"{args.sweep_cache}", file=sys.stderr)

    if (args.sweep_cache_prune is not None
            or args.sweep_cache_prune_days is not None):
        if args.sweep_cache is None:
            sys.exit("--sweep-cache-prune requires --sweep-cache DIR")
        from repro_torch.core.sim import prune_sweep_cache

        max_bytes = (None if args.sweep_cache_prune is None
                     else int(args.sweep_cache_prune * 1e6))
        try:
            removed = prune_sweep_cache(
                args.sweep_cache, max_bytes=max_bytes,
                max_age_days=args.sweep_cache_prune_days)
        except ValueError as e:
            sys.exit(str(e))
        print(f"sweep-cache: pruned {removed} cell(s) from "
              f"{args.sweep_cache}", file=sys.stderr)

    backend_opts = {"device": args.device, "substeps": args.backend_substeps,
                    "host_devices": args.backend_host_devices}

    arrival = None
    if args.arrival is not None:
        if args.rate is None or args.rate <= 0:
            sys.exit("--arrival requires --rate OPS_PER_S > 0")
        arrival = {"kind": args.arrival, "rate": args.rate}
        if args.burst is not None:
            if args.arrival != "bursty":
                sys.exit("--burst only applies to --arrival bursty")
            if not 0 < args.burst <= 1:
                sys.exit("--burst must be in (0, 1]")
            arrival["on_fraction"] = args.burst
    elif args.rate is not None or args.burst is not None:
        sys.exit("--rate/--burst require --arrival KIND")

    cluster = None
    if args.nodes is not None:
        if args.nodes < 1:
            sys.exit("--nodes must be >= 1")
        cluster = {"n_nodes": args.nodes}
        if args.replicas is not None:
            if not 1 <= args.replicas <= args.nodes:
                sys.exit("--replicas must be in [1, --nodes]")
            cluster["replication"] = args.replicas
            cluster["replica_policy"] = "spread"
        if args.route_latency is not None:
            if args.route_latency < 0:
                sys.exit("--route-latency must be >= 0")
            cluster["L_route_us"] = args.route_latency
    elif args.replicas is not None or args.route_latency is not None:
        sys.exit("--replicas/--route-latency require --nodes N")

    # No sweep starts on a device that is not there.
    if common.device_missing(args.backend, args.device):
        sys.exit("benchmarks.run_torch: no CUDA device is available; the "
                 "torch backend runs on the card by default: pass --device "
                 "cpu (the plain PyTorch step on the host) or --backend "
                 "loop (the host interpreter)")

    print("name,us_per_call,derived")

    if args.suite is not None:
        if args.scenario is not None or args.engine is not None:
            sys.exit("--suite is exclusive with --scenario/--engine")
        if arrival is not None or cluster is not None:
            sys.exit("--suite specs are self-contained; drop "
                     "--arrival/--nodes overlays")
        run_suite_cmd(args.suite, args.suite_out, args.collect_latency,
                      args.adaptive, args.backend,
                      backend_opts=backend_opts)
        return
    if args.suite_out is not None:
        sys.exit("--suite-out requires --suite DIR")

    if args.scenario is not None:
        from repro_torch.core.experiment import Scenario

        try:
            with open(args.scenario) as f:
                spec = f.read()
        except OSError as e:
            sys.exit(f"cannot read scenario spec: {e}")
        try:
            scenario = Scenario.from_json(spec)
        except (ValueError, TypeError, KeyError) as e:
            sys.exit(f"bad scenario spec {args.scenario!r}: {e}")
        run_scenario_cmd(scenario, args.artifact, args.collect_latency,
                         args.adaptive, args.backend,
                         backend_opts=backend_opts, arrival=arrival,
                         cluster=cluster)
        return

    if args.engine is not None:
        if args.devices < 1:
            sys.exit("--devices must be >= 1")
        if args.cores < 1:
            sys.exit("--cores must be >= 1")
        from repro_torch.core.experiment import default_scenario

        try:
            scenario = default_scenario(args.engine, n_ssd=args.devices,
                                        n_cores=args.cores)
        except KeyError as e:  # unknown engine: get_engine lists what exists
            sys.exit(str(e.args[0]) if e.args else str(e))
        prefix = f"matrix/{args.engine}/ssd{args.devices}"
        if args.cores > 1:
            prefix += f"/cores{args.cores}"
        run_scenario_cmd(scenario, args.artifact, args.collect_latency,
                         args.adaptive, args.backend,
                         prefix=prefix,
                         backend_opts=backend_opts, arrival=arrival,
                         cluster=cluster)
        return

    failed = 0
    for name, fn in _benches(args.device):
        if args.only and args.only not in name:
            continue
        t0 = time.time()
        try:
            fn()
            print(f"bench/{name}/wall,{(time.time() - t0) * 1e6:.0f},ok")
        except Exception as e:  # noqa: BLE001
            failed += 1
            traceback.print_exc()
            print(f"bench/{name}/wall,0,FAILED:{type(e).__name__}:{e}")
    if failed:
        sys.exit(1)


if __name__ == "__main__":
    main()
