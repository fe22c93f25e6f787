#!/usr/bin/env python
"""Benchmark: the port's torch sweep backend vs. the forked-process loop pipeline.

The PyTorch / CUDA port's counterpart of ``benchmarks/jax_grid_bench.py``:
the same suites with the same cells, traces and loop side, with the torch
grid (``sweep_latency(backend="torch")`` on ``--device``, default ``cuda``)
in place of the jax one.  Suites:

``default``
    The paper's default scenario grid (6 latencies x 5 thread candidates,
    one LSM default-pairing trace).  The loop side is the real forked
    worker pipeline; the reference's floor is warm grid >= 1x.
``mega``
    4 engines x n_ssd {1,2} x 128 latencies x {8,16,32,64} threads --
    4096 cells at 2000 ops, each engine x device point one grid call (the
    2-SSD half uses the matrix device config with IO token clocks).  The
    loop side runs the identical cells through the same pipeline.
    Floor: warm grid >= 5x.
``het``
    One engine, 64 latencies x a maximally uneven thread axis (8..128):
    the monolithic layout (``replay_torch.sweep_grid(...,
    bucket_threads=False, early_exit=False)``: every cell padded to 128
    threads and run to the global step bound) against the cohort layout
    with early exit, on identical cells.  Records ``torch_mono_warm_s`` /
    ``mono_speedup`` and the wasted-step counters.  Floor: cohort >= 1.5x
    monolithic.  The port tests the early exit every 4 chunks (4096 steps;
    ``docs/PORT.md`` C2), so ``steps_saved_frac`` is coarser than the
    reference's.
``smoke``
    A seconds-scale slice (one small trace, 8 cells).

Because both sides run, every entry also records ``worst_rel``: the largest
relative gap between a torch cell and its loop cell over every cell of the
grid, beside its bound ``repro_torch.core.conformance.grid_tol(n_ops)``
(``worst_rel_bound``) and the loop's own spread, ``loop_reseed_worst_rel``:
the same gap between the loop at ``seed`` and at ``seed + 1`` (untimed);
and ``fused_steps_launches``, the scheduler kernel's launches in one warm
call (0 on the CPU, where the plain step runs).

The document has its own schema, ``repro_torch.grid_bench/v1``: the
reference's with ``torch_cold_s`` / ``torch_warm_s`` / ``torch_cohort_warm_s``
/ ``torch_mono_warm_s`` in place of the ``jax_*`` fields, plus the fields
above.  :func:`validate` holds the reference checker's field and invariant
checks, renamed (cells = latencies x threads, times > 0, het
``cell_steps_run`` <= ``cell_steps_bound``); :func:`over_bound` lists the
entries whose ``worst_rel`` passes its bound, and :func:`floors` reports
the reference's speed floors.  A floor measures the host's loop pipeline
as much as the device, so a missed floor is reported, never a validation
failure; the CLI prints both and exits non-zero only on an invalid
document.  Written to
``chiprun_out/torch_grid_bench.json`` by default::

    PYTHONPATH=src python -m benchmarks.torch_grid_bench \\
        --suite default,mega,het,smoke

Cold is the first torch call in the process, after the kernel library is
built and the CUDA context made; warm is the best of ``--reps``.  Every
loop grid is timed before CUDA is initialized, so the pipeline keeps its
plain-fork worker start method (see ``sweep._pick_context``).  Without the
device the bench exits non-zero before any work.  It imports torch, numpy
and the port, never ``jax`` or the reference package.
"""
from __future__ import annotations

import argparse
import json
import os
import platform
import sys
import time
from pathlib import Path

from dataclasses import replace

import numpy as np

SCHEMA = "repro_torch.grid_bench/v1"
US = 1e-6
OUT = Path(__file__).resolve().parents[1] / "chiprun_out" / \
    "torch_grid_bench.json"

# The mega suite's axes (benchmarks/jax_grid_bench.py): every registered
# engine family with a distinct suboperation mix, an n_ssd axis, a fine
# latency axis, and the pow2 thread candidates.
MEGA_ENGINES = ("lsm", "hash-index", "tree-index", "two-tier-cache")
MEGA_N_SSD = (1, 2)
MEGA_N_LATS = 128
MEGA_CANDS = (8, 16, 32, 64)
MEGA_N_OPS = 2000

# The het suite's axes: a deliberately uneven thread spread (16x between the
# narrowest and widest cell, straddling five pow2 buckets).
HET_N_LATS = 64
HET_CANDS = (8, 16, 24, 32, 48, 64, 96, 128)
HET_N_OPS = 2000

SUITES = ("default", "mega", "het", "smoke")

# The reference's acceptance floors (tools/check_bench.py), reported.
DEFAULT_MIN_SPEEDUP = 1.0
MEGA_MIN_SPEEDUP = 5.0
MEGA_MIN_CELLS = 2000
HET_MIN_MONO_SPEEDUP = 1.5

_NUM = (int, float)
_ENTRY_FIELDS = {
    "name": str, "engine": str, "n_ssd": int, "n_latencies": int,
    "n_threads": int, "cells": int, "n_ops": int, "loop_s": _NUM,
    "loop_mode": str, "torch_cold_s": _NUM, "torch_warm_s": _NUM,
    "warm_speedup": _NUM, "worst_rel": _NUM, "worst_rel_bound": _NUM,
    "loop_reseed_worst_rel": _NUM, "fused_steps_launches": int,
}
_HET_FIELDS = {
    "torch_cohort_warm_s": _NUM, "torch_mono_warm_s": _NUM,
    "mono_speedup": _NUM, "cell_steps_bound": int, "cell_steps_run": int,
    "steps_saved_frac": _NUM,
}


def _timed(fn, *a, **kw):
    t0 = time.perf_counter()
    out = fn(*a, **kw)
    return time.perf_counter() - t0, out


def _trace(engine: str, n_keys: int, n_wl_ops: int):
    """The engine's default-pairing zipf trace (compiled)."""
    from repro_torch.core import workloads
    from repro_torch.core.engines import available_engines, run_trace

    store = available_engines()[engine](n_keys)
    wl = workloads.zipf(n_keys, n_wl_ops, 0.99, (1, 0), seed=3)
    return run_trace(store, wl).trace


def _suite_specs(suite: str, n_keys=30_000, n_wl_ops=10_000, n_ops=5000):
    """The grids of one suite: (name, engine, dev_kwargs, trace_params,
    lats, cands, n_ops) tuples -- the reference bench's cells."""
    from repro_torch.core.experiment import Scenario

    if suite == "default":
        sc = Scenario(engine="lsm")
        return [("default", "lsm", {},
                 (n_keys, n_wl_ops),
                 [l * US for l in sc.latencies_us],
                 list(sc.thread_candidates), n_ops)]
    if suite == "mega":
        lats = [float(l) * US for l in
                np.round(np.linspace(0.1, 10.0, MEGA_N_LATS), 4)]
        devs = {1: {},
                2: dict(n_ssd=2, R_io=250e3, L_switch=0.3 * US)}
        return [(f"mega:{eng}:ssd{n_ssd}", eng, devs[n_ssd],
                 (n_keys, n_wl_ops),
                 lats, list(MEGA_CANDS), MEGA_N_OPS)
                for eng in MEGA_ENGINES for n_ssd in MEGA_N_SSD]
    if suite == "het":
        lats = [float(l) * US for l in
                np.round(np.linspace(0.1, 10.0, HET_N_LATS), 4)]
        return [("het:lsm", "lsm", {},
                 (n_keys, n_wl_ops),
                 lats, list(HET_CANDS), HET_N_OPS)]
    if suite == "smoke":
        return [("smoke", "hash-index", {}, (4_000, 1_500),
                 [l * US for l in (0.5, 2, 5, 9)], [8, 16], 800)]
    raise SystemExit(f"unknown suite {suite!r} "
                     "(valid: default, mega, het, smoke)")


def _worst_rel(loop_pts, torch_pts) -> float:
    """Largest relative gap between a torch cell and its loop cell."""
    worst = 0.0
    for lp, tp in zip(loop_pts, torch_pts):
        for n, ref in lp.per_thread.items():
            worst = max(worst, abs(tp.per_thread[n] - ref) / ref)
    return worst


def run(suites, reps: int = 3, device="cuda", n_ops: int = 5000,
        n_keys: int = 30_000, n_wl_ops: int = 10_000) -> dict:
    """The measurement document of ``suites`` (loop side first)."""
    from repro_torch.core.conformance import grid_tol
    from repro_torch.core.sim import SimConfig
    from repro_torch.core.sim.sweep import sweep_latency

    specs = []
    for suite in suites:
        specs.extend(_suite_specs(suite, n_keys, n_wl_ops, n_ops))

    traces = {}
    for _name, eng, _dev, (nk, nw), *_rest in specs:
        if (eng, nk, nw) not in traces:
            traces[(eng, nk, nw)] = _trace(eng, nk, nw)

    # Loop side first, before CUDA is initialized (keeps the pipeline's
    # plain-fork workers), timed end to end as a user would run it.
    entries, loop_pts = [], []
    for name, eng, dev, (nk, nw), lats, cands, n in specs:
        cfg = SimConfig(P=12, seed=7, **dev)
        t_loop, pts = _timed(sweep_latency, cfg, traces[(eng, nk, nw)],
                             lats, cands, n_ops=n, backend="loop")
        loop_pts.append(pts)
        # the loop's own spread: the same cells at the next seed (untimed)
        reseed = sweep_latency(replace(cfg, seed=cfg.seed + 1),
                               traces[(eng, nk, nw)], lats, cands, n_ops=n,
                               backend="loop")
        entries.append({
            "name": name, "engine": eng, "n_ssd": cfg.n_ssd,
            "n_latencies": len(lats), "n_threads": len(cands),
            "cells": len(lats) * len(cands), "n_ops": n,
            "loop_s": t_loop, "loop_mode": "pipeline",
            "loop_reseed_worst_rel": _worst_rel(pts, reseed),
        })
        print(f"# {name}: loop pipeline {t_loop:.2f}s "
              f"({len(lats) * len(cands)} cells)", file=sys.stderr,
              flush=True)

    import torch

    from repro_torch.core.sim import replay_torch
    from repro_torch.kernels import sched_step

    dev = replay_torch.resolve_device(device)
    if dev.type == "cuda":
        from repro_torch.kernels import _build

        _build.load("sched_step")
        torch.zeros(1, device=dev)
        torch.cuda.synchronize(dev)

    for entry, pts_loop, (name, eng, dev_kw, (nk, nw), lats, cands, n) \
            in zip(entries, loop_pts, specs):
        cfg = SimConfig(P=12, seed=7, **dev_kw)
        tr = traces[(eng, nk, nw)]

        def torch_sweep():
            return sweep_latency(cfg, tr, lats, cands, n_ops=n,
                                 backend="torch", device=dev)

        t_cold, pts = _timed(torch_sweep)
        warm = []
        for _ in range(reps):
            before = sched_step.fused_steps.launches
            warm.append(_timed(torch_sweep)[0])
            launches = sched_step.fused_steps.launches - before
        t_warm = min(warm)
        worst = _worst_rel(pts_loop, pts)
        entry.update(
            torch_cold_s=t_cold, torch_warm_s=t_warm,
            warm_speedup=entry["loop_s"] / t_warm, worst_rel=worst,
            worst_rel_bound=grid_tol(n), fused_steps_launches=launches)
        print(f"# {name}: torch cold {t_cold:.3f}s warm {t_warm:.3f}s "
              f"-> {entry['warm_speedup']:.2f}x; worst cell {worst:.4%} "
              f"(bound {grid_tol(n):.4%}); {launches} launches",
              file=sys.stderr, flush=True)

        if name.startswith("het"):
            # Cohort vs. monolithic on identical cells, both through
            # sweep_grid directly.  bucket_threads=False + early_exit=False
            # is the single-plane layout: one T_max-wide plane, one global
            # step bound.
            def grid(**kw):
                return replay_torch.sweep_grid(cfg, tr, lats, cands,
                                               n_ops=n, device=dev, **kw)

            g = grid()
            t_coh = min(_timed(grid)[0] for _ in range(reps))
            grid(bucket_threads=False, early_exit=False)   # first call
            t_mono = min(_timed(grid, bucket_threads=False,
                                early_exit=False)[0] for _ in range(reps))
            saved = 1.0 - g.cell_steps_run / max(g.cell_steps_bound, 1)
            entry.update(
                torch_cohort_warm_s=t_coh, torch_mono_warm_s=t_mono,
                mono_speedup=t_mono / t_coh,
                cell_steps_bound=int(g.cell_steps_bound),
                cell_steps_run=int(g.cell_steps_run),
                steps_saved_frac=saved)
            print(f"# {name}: cohort {t_coh:.3f}s vs monolithic "
                  f"{t_mono:.3f}s -> {entry['mono_speedup']:.2f}x "
                  f"(early exit saved {saved:.1%} of bounded steps)",
                  file=sys.stderr, flush=True)

    def _agg(prefix):
        sel = [e for e in entries if e["name"].startswith(prefix)]
        if not sel:
            return None
        loop = sum(e["loop_s"] for e in sel)
        warm = sum(e["torch_warm_s"] for e in sel)
        return {"cells": sum(e["cells"] for e in sel), "loop_s": loop,
                "torch_warm_s": warm, "warm_speedup": loop / warm}

    summary = {k: v for k, v in (
        ("default", _agg("default")), ("mega", _agg("mega:")),
        ("het", _agg("het")), ("smoke", _agg("smoke"))) if v is not None}
    het_sel = [e for e in entries if e["name"].startswith("het")]
    if het_sel:
        coh = sum(e["torch_cohort_warm_s"] for e in het_sel)
        mono = sum(e["torch_mono_warm_s"] for e in het_sel)
        bound = sum(e["cell_steps_bound"] for e in het_sel)
        ran = sum(e["cell_steps_run"] for e in het_sel)
        summary["het"].update(
            torch_cohort_warm_s=coh, torch_mono_warm_s=mono,
            mono_speedup=mono / coh,
            steps_saved_frac=1.0 - ran / max(bound, 1))
    return {
        "schema": SCHEMA,
        "host": {
            "platform": platform.platform(),
            "machine": platform.machine(),
            "cpu_count": os.cpu_count(),
            "python": platform.python_version(),
            "torch": torch.__version__,
            "device": (torch.cuda.get_device_name(dev)
                       if dev.type == "cuda" else "cpu"),
        },
        "entries": entries,
        "summary": summary,
    }


def _check_fields(obj: dict, fields: dict, where: str) -> None:
    for field, typ in fields.items():
        if field not in obj:
            raise ValueError(f"{where} missing {field!r}")
        v = obj[field]
        if not isinstance(v, typ) or isinstance(v, bool):
            raise ValueError(f"{where} field {field!r} has type "
                             f"{type(v).__name__}")


def validate(doc: dict) -> list[str]:
    """Schema and invariants of a grid-bench document (``ValueError`` on
    the first violation; the lines of what was checked otherwise)."""
    if doc.get("schema") != SCHEMA:
        raise ValueError(f"schema {doc.get('schema')!r}, wanted {SCHEMA!r}")
    entries = doc.get("entries")
    if not isinstance(entries, list) or not entries:
        raise ValueError("entries must be a non-empty list")
    if not isinstance(doc.get("summary"), dict) or not doc["summary"]:
        raise ValueError("summary must be a non-empty object")
    for e in entries:
        if not isinstance(e, dict):
            raise ValueError(f"entry is not an object: {e!r}")
        tag = f"entry {e.get('name', '?')!r}"
        _check_fields(e, _ENTRY_FIELDS, tag)
        if e["cells"] != e["n_latencies"] * e["n_threads"]:
            raise ValueError(f"{tag}: cells != lats * threads")
        for field in ("loop_s", "torch_cold_s", "torch_warm_s",
                      "warm_speedup"):
            if e[field] <= 0:
                raise ValueError(f"{tag}: {field} must be > 0")
        if e["worst_rel"] < 0 or e["worst_rel_bound"] <= 0:
            raise ValueError(f"{tag}: worst_rel must be >= 0 and its bound "
                             f"> 0")
        if e["name"].startswith("het"):
            _check_fields(e, _HET_FIELDS, tag)
            if e["cell_steps_run"] > e["cell_steps_bound"]:
                raise ValueError(
                    f"{tag}: cell_steps_run exceeds cell_steps_bound")
    if "het" in doc["summary"] and \
            "mono_speedup" not in doc["summary"]["het"]:
        raise ValueError("het summary missing 'mono_speedup'")
    cells = sum(e["cells"] for e in entries)
    return [f"{len(entries)} entries, {cells} cells: fields and invariants "
            f"ok"]


def over_bound(doc: dict) -> list[dict]:
    """The entries whose worst cell lies farther from its loop cell than
    ``grid_tol(n_ops)``."""
    return [{k: e[k] for k in ("name", "worst_rel", "worst_rel_bound",
                               "loop_reseed_worst_rel")}
            for e in doc["entries"] if e["worst_rel"] > e["worst_rel_bound"]]


def floors(doc: dict) -> list[dict]:
    """The reference's speed floors against this document: one record per
    suite present, ``met`` false where the floor is missed."""
    out = []
    s = doc["summary"]
    if "default" in s:
        v = s["default"]["warm_speedup"]
        out.append(dict(suite="default", measure="warm_speedup", value=v,
                        floor=DEFAULT_MIN_SPEEDUP,
                        met=v >= DEFAULT_MIN_SPEEDUP))
    if "mega" in s:
        v, cells = s["mega"]["warm_speedup"], s["mega"]["cells"]
        out.append(dict(suite="mega", measure="warm_speedup", value=v,
                        floor=MEGA_MIN_SPEEDUP, cells=cells,
                        met=v >= MEGA_MIN_SPEEDUP
                        and cells >= MEGA_MIN_CELLS))
    if "het" in s:
        v = s["het"]["mono_speedup"]
        out.append(dict(suite="het", measure="mono_speedup", value=v,
                        floor=HET_MIN_MONO_SPEEDUP,
                        met=v >= HET_MIN_MONO_SPEEDUP))
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--suite", default="default",
                    help="comma-separated: default, mega, het, smoke")
    ap.add_argument("--out", default=str(OUT), metavar="OUT.json",
                    help=f"write the measurement JSON here (default: {OUT})")
    ap.add_argument("--reps", type=int, default=3,
                    help="warm-run repetitions (best is reported)")
    ap.add_argument("--device", default="cuda",
                    help="device of the torch side (default cuda; cpu runs "
                         "the plain PyTorch step on the host)")
    ap.add_argument("--n-ops", type=int, default=5000,
                    help="measured ops per cell (default suite)")
    ap.add_argument("--n-keys", type=int, default=30_000)
    ap.add_argument("--n-wl-ops", type=int, default=10_000)
    args = ap.parse_args(argv)
    if args.reps < 1:
        sys.exit("torch_grid_bench: --reps must be >= 1")

    from .common_torch import device_missing

    if device_missing("torch", args.device):
        sys.exit("torch_grid_bench: no CUDA device is available; pass "
                 "--device cpu to run the torch side's plain PyTorch step "
                 "on the host")
    suites = [s.strip() for s in args.suite.split(",")]
    for s in suites:
        _suite_specs(s)                      # unknown names fail up front
    doc = run(suites, args.reps, args.device, args.n_ops, args.n_keys,
              args.n_wl_ops)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(doc, indent=2) + "\n")
    print(f"# wrote {out}", file=sys.stderr)
    try:
        for line in validate(doc):
            print(f"# validate: {line}", file=sys.stderr)
    except ValueError as e:
        sys.exit(f"torch_grid_bench: {out}: {e}")
    for e in over_bound(doc):
        print(f"# {e['name']}: worst cell {e['worst_rel']:.4%} from the loop, "
              f"over grid_tol {e['worst_rel_bound']:.4%} (the loop against "
              f"itself at the next seed: {e['loop_reseed_worst_rel']:.4%})",
              file=sys.stderr)
    for f in floors(doc):
        print(f"# floor {f['suite']}: {f['measure']} {f['value']:.3f}x "
              f"(floor {f['floor']}x) {'met' if f['met'] else 'MISSED'}",
              file=sys.stderr)


if __name__ == "__main__":
    main()
