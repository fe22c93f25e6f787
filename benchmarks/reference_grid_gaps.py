#!/usr/bin/env python
"""How far the reference's jax grid lies from its own host loop, cell by cell.

A reference-side measurement (it imports ``repro`` and jax, never the port):
the cells of ``benchmarks/jax_grid_bench.py``'s suites, of
``benchmarks/paper_figs.py``'s fig13 and of ``benchmarks.run --engine lsm
--cores 4``, each swept by ``sweep_latency(backend="jax")`` and by the
compiled loop, and for each grid the largest relative gap of a cell and the
number of cells past ``repro.core.conformance.jax_grid_tol(n_ops)``.  The
port's torch grid is held to the same law against the same loop
(``chip_smoke.py``, ``benchmarks/torch_grid_bench.py``); these are the
reference's figures beside it (``ROADMAP.md`` C17).  Virtual-time results:
the same on any host.  Run on a CPU::

    PYTHONPATH=src python -m benchmarks.reference_grid_gaps [--only mega]
"""
from __future__ import annotations

import argparse
import sys


def _jax():
    """The reference's grid backend imports ``jax.experimental.enable_x64``,
    which newer jax releases keep as ``jax.enable_x64`` only."""
    import jax
    import jax.experimental

    if not hasattr(jax.experimental, "enable_x64"):
        jax.experimental.enable_x64 = jax.enable_x64
        sys.modules["jax.experimental.enable_x64"] = jax.experimental


def _gaps(loop_pts, grid_pts):
    return [abs(g.per_thread[c] - lp.per_thread[c]) / lp.per_thread[c]
            for lp, g in zip(loop_pts, grid_pts) for c in lp.per_thread]


def _report(name, rel, tol):
    print(f"{name},{max(rel):.6f},over={sum(r > tol for r in rel)};"
          f"cells={len(rel)};tol={tol:.6f}", flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default="", help="substring filter on names")
    args = ap.parse_args(argv)
    _jax()

    from repro.core.conformance import jax_grid_tol
    from repro.core.experiment import Experiment, RunOptions, default_scenario
    from repro.core.sim import SimConfig, sweep_latency

    from . import jax_grid_bench

    print("name,worst_rel,derived")
    bench_args = argparse.Namespace(n_keys=30_000, n_wl_ops=10_000,
                                    n_ops=5000)
    traces = {}
    for suite in ("default", "mega", "het", "smoke"):
        for name, eng, dev, (nk, nw), lats, cands, n in \
                jax_grid_bench._suite_specs(suite, bench_args):
            if args.only not in f"grid_bench/{name}":
                continue
            if (eng, nk, nw) not in traces:
                traces[(eng, nk, nw)] = jax_grid_bench._trace(eng, nk, nw)
            cfg = SimConfig(P=12, seed=7, **dev)
            tr = traces[(eng, nk, nw)]
            loop = sweep_latency(cfg, tr, lats, cands, n_ops=n,
                                 backend="loop", processes=1)
            grid = sweep_latency(cfg, tr, lats, cands, n_ops=n,
                                 backend="jax")
            _report(f"grid_bench/{name}", _gaps(loop, grid), jax_grid_tol(n))

    def scenario_gaps(sc):
        loop = Experiment(sc, RunOptions(backend="loop", processes=1)).run()
        grid = Experiment(sc, RunOptions(backend="jax")).run()
        return _gaps(loop.points, grid.points)

    if args.only in "fig13_engine_matrix":
        rel = []
        for engine in ("tree-index", "lsm", "two-tier-cache", "hash-index",
                       "slab-cache"):
            for n_ssd in (1, 2):
                rel += scenario_gaps(default_scenario(
                    engine, n_ssd=n_ssd, latencies_us=(0.1, 1, 5, 10),
                    thread_candidates=(24, 40, 56), n_ops=4000))
        _report("fig13_engine_matrix", rel, jax_grid_tol(4000))
    if args.only in "matrix/lsm/ssd1/cores4":
        sc = default_scenario("lsm", n_cores=4)
        _report("matrix/lsm/ssd1/cores4", scenario_gaps(sc),
                jax_grid_tol(sc.n_ops))


if __name__ == "__main__":
    main()
