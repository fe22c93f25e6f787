#!/usr/bin/env python
"""Benchmark: tail latency vs. memory latency under open-loop load, on the port.

The PyTorch / CUDA port's counterpart of ``benchmarks/tail_latency_bench.py``:
the same ``FULL`` and ``SMOKE`` suites, protocol and schema
(``repro.tail_latency_bench/v1``, backend-neutral and validated by
``tools/check_bench.py`` unchanged), over :mod:`repro_torch`.

The paper's Eq. 14 story is about *mean* throughput; this bench replays the
same apparatus open-loop -- a Poisson arrival process offers a fixed load
while the memory latency sweeps -- and records where the *tail* (P50 / P99
/ max sojourn: arrival -> completion, queueing included) lands at each
operating point.  Protocol, per suite:

1. *Capacity probe*: a closed-loop sweep over the memory-latency axis at
   the suite's fixed thread count; the lowest-latency point's throughput
   is the capacity ``C``.
2. *Open-loop grid*: for each offered-load fraction (0.5 x C, 0.9 x C)
   and each memory latency, one open-loop Poisson sweep cell
   (``sweep_latency`` with an :class:`~repro_torch.core.sim.ArrivalSpec`,
   ``collect_percentiles=True``).

``--backend torch`` (the default) runs both phases on the device grid
(``--device``, default ``cuda``), where the percentiles come from the
per-cell log histogram (``source: "hist"``), each capped at the exactly
tracked maximum (a bin's centre can pass it when both share the top bin,
which ``tools/check_bench.py`` refuses); ``--backend loop`` runs them on
the host interpreter with exact sorted percentiles (``source: "exact"``),
as the reference does.  Without the device a torch run exits non-zero
before any work.  The ``host`` block also names the device::

    PYTHONPATH=src python -m benchmarks.tail_latency_bench_torch \\
        --out chiprun_out/tail_latency_bench_torch.json
    python tools/check_bench.py chiprun_out/tail_latency_bench_torch.json

``--smoke`` shrinks the trace and op counts to a seconds-scale slice (same
schema); ``--fig tail.png`` additionally renders the P99-vs-L curves per
offered load with matplotlib (Agg), and exits non-zero, after writing the
JSON, where matplotlib is not installed.  It imports torch, numpy and the
port, never ``jax`` or the reference package.
"""
from __future__ import annotations

import argparse
import json
import os
import platform
import sys

SCHEMA = "repro.tail_latency_bench/v1"
US = 1e-6

LOAD_FRACS = (0.5, 0.9)

# Full suite: the default hash-index pairing trace, one fixed pool of 16
# threads, the paper's memory-latency axis.  Smoke: the grid bench's smoke
# trace (4k keys) and a 4-point latency axis.
FULL = dict(name="tail", engine="hash-index", n_keys=30_000,
            n_wl_ops=10_000, n_ops=4000, threads=16,
            lats_us=(0.1, 0.5, 1.0, 2.0, 3.0, 5.0, 8.0, 10.0))
SMOKE = dict(name="tail-smoke", engine="hash-index", n_keys=4_000,
             n_wl_ops=1_500, n_ops=800, threads=16,
             lats_us=(0.5, 2.0, 5.0, 9.0))


def _trace(engine: str, n_keys: int, n_wl_ops: int):
    from repro_torch.core import workloads
    from repro_torch.core.engines import available_engines, run_trace

    store = available_engines()[engine](n_keys)
    wl = workloads.zipf(n_keys, n_wl_ops, 0.99, (1, 0), seed=3)
    return run_trace(store, wl).trace


def run_suite(suite: dict, backend: str, device="cuda") -> dict:
    from repro_torch.core.sim import ArrivalSpec, SimConfig, sweep_latency

    cfg = SimConfig(P=12, seed=7)
    tr = _trace(suite["engine"], suite["n_keys"], suite["n_wl_ops"])
    lats = [l * US for l in suite["lats_us"]]
    cands = [suite["threads"]]
    n_ops = suite["n_ops"]

    closed = sweep_latency(cfg, tr, lats, cands, n_ops=n_ops,
                           backend=backend, device=device)
    capacity = float(closed[0].throughput)
    print(f"# {suite['name']}: capacity {capacity / 1e3:.1f} kops/s at "
          f"L={suite['lats_us'][0]}us x {suite['threads']} threads",
          file=sys.stderr, flush=True)

    entries = []
    for frac in LOAD_FRACS:
        rate = frac * capacity
        spec = ArrivalSpec(kind="poisson", rate=rate, seed=11)
        pts = sweep_latency(cfg, tr, lats, cands, n_ops=n_ops,
                            backend=backend, device=device, arrival=spec,
                            collect_percentiles=True)
        for l_us, pt in zip(suite["lats_us"], pts):
            s = pt.result.latency_summary

            def pct(v, s=s):
                # A histogram quantile is its bin's geometric centre and can
                # pass the exactly tracked max when both share the top bin;
                # the true quantile cannot (exact percentiles: a no-op).
                return round(min(v, s.max) / US, 3)

            entries.append({
                "name": suite["name"], "engine": suite["engine"],
                "L_us": l_us, "n_threads": pt.n_threads, "n_ops": n_ops,
                "offered_frac": frac,
                "offered_load": round(rate, 1),
                "achieved_load": round(float(pt.throughput), 1),
                "p50_us": pct(s.p50),
                "p90_us": pct(s.p90),
                "p99_us": pct(s.p99),
                "max_us": round(s.max / US, 3),
                "count": s.count, "missed": s.missed,
                "miss_rate": round(s.miss_rate, 6),
                "source": s.source,
            })
        lo, hi = entries[-len(lats)], entries[-1]
        print(f"# {suite['name']}: load {frac:.0%} -> P99 "
              f"{lo['p99_us']:.1f}us @ {lo['L_us']}us ... "
              f"{hi['p99_us']:.1f}us @ {hi['L_us']}us",
              file=sys.stderr, flush=True)
    return {"capacity": round(capacity, 1), "entries": entries}


def render_fig(entries: list[dict], path: str) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(6, 4))
    fracs = sorted({e["offered_frac"] for e in entries})
    for frac in fracs:
        sel = sorted((e for e in entries if e["offered_frac"] == frac),
                     key=lambda e: e["L_us"])
        ax.plot([e["L_us"] for e in sel], [e["p99_us"] for e in sel],
                marker="o", label=f"P99 @ {frac:.0%} load")
        ax.plot([e["L_us"] for e in sel], [e["p50_us"] for e in sel],
                marker=".", linestyle="--", label=f"P50 @ {frac:.0%} load")
    ax.set_xlabel("memory latency L (us)")
    ax.set_ylabel("sojourn latency (us)")
    ax.set_yscale("log")
    ax.set_title("Open-loop tail vs. memory latency (Eq. 14 at the tail)")
    ax.legend(fontsize=8)
    ax.grid(True, alpha=0.3)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    print(f"# wrote {path}", file=sys.stderr)


def document(suite: dict, backend: str, device="cuda") -> dict:
    """The measurement document of one suite on ``backend``."""
    import torch

    res = run_suite(suite, backend, device)
    if backend != "torch":
        dev_name = "host"
    elif torch.device(device).type == "cuda":
        dev_name = torch.cuda.get_device_name(torch.device(device))
    else:
        dev_name = "cpu"
    return {
        "schema": SCHEMA,
        "host": {
            "platform": platform.platform(),
            "machine": platform.machine(),
            "cpu_count": os.cpu_count(),
            "python": platform.python_version(),
            "device": dev_name,
        },
        "backend": backend,
        "entries": res["entries"],
        "summary": {
            suite["name"]: {
                "capacity": res["capacity"],
                "offered_fracs": list(LOAD_FRACS),
                "n_points": len(res["entries"]),
            },
        },
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="seconds-scale CI slice (small trace, 800 ops)")
    ap.add_argument("--backend", default="torch", choices=("torch", "loop"),
                    help="sweep backend (default torch: the device grid, "
                         "log-histogram percentiles; loop: exact "
                         "percentiles on the host)")
    ap.add_argument("--device", default="cuda",
                    help="device of the torch backend (default cuda; cpu "
                         "runs the plain PyTorch step on the host)")
    ap.add_argument("--out", default=None, metavar="OUT.json",
                    help="write the measurement JSON here (default: "
                         "print to stdout)")
    ap.add_argument("--fig", default=None, metavar="OUT.png",
                    help="also render the P50/P99-vs-latency figure "
                         "(needs matplotlib)")
    args = ap.parse_args(argv)

    from .common_torch import device_missing

    if device_missing(args.backend, args.device):
        sys.exit("tail_latency_bench_torch: no CUDA device is available; "
                 "pass --device cpu (the plain PyTorch step on the host) or "
                 "--backend loop (the host interpreter)")

    suite = SMOKE if args.smoke else FULL
    doc = document(suite, args.backend, args.device)
    text = json.dumps(doc, indent=2) + "\n"
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
        print(f"# wrote {args.out}", file=sys.stderr)
    else:
        print(text, end="")
    if args.fig:
        try:
            import matplotlib  # noqa: F401
        except ImportError:
            sys.exit(f"tail_latency_bench_torch: --fig {args.fig}: "
                     "matplotlib is not installed; no figure written (the "
                     "JSON is)")
        render_fig(doc["entries"], args.fig)


if __name__ == "__main__":
    main()
