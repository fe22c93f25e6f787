"""Where one cell's sweeps spend the host's time, span by span: the
program's spans (``repro_torch.obs``) read without a profiler and as
``--trace 1`` runs read them, and what a span costs.  No metric reads this
tool; it reproduces the split that ``PERF.md`` reports.

    python3 -m kvsimbench.spans --workload <cell> --seed <n> \\
        [--sweeps 6] [--blocks 3]

Set-up as ``kvsimbench.run`` (the inputs from ``--seed``, the engine walk,
a warm-up sweep).  Then ``--blocks`` times, ``--sweeps`` sweeps in each of
three modes, one after another: untraced, under ``obs.recording()`` with no
profiler, and under ``torch.profiler`` with CUDA activity alone (as the
run's first profile).  Last, the cost of one span: the null context, a
recorded span, and a ``record_function`` pair with no profiler and in a
CUDA-only session.  Prints one JSON line: for each mode the mean sweep
wall (host clock) and, from the frames, the median self ms a sweep of each
span and the spans a sweep; the CUDA-only profile's device idle share; the
span costs in microseconds; the card.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import sys
import time

from . import bench, deployment, devtrace, program, run

MODES = ("untraced", "recording", "cuda_only")


def _per_call_us(fn, n: int) -> float:
    t = time.perf_counter_ns()
    for _ in range(n):
        fn()
    return (time.perf_counter_ns() - t) / n * 1e-3


def span_costs(n: int = 20000) -> dict:
    """Microseconds a call: a null span, a recorded span inside an open
    sweep, and a ``record_function`` pair without and under a CUDA-only
    profile."""
    from torch.autograd.profiler import record_function
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import obs

    def null():
        with obs.span("x"):
            pass

    def pair():
        with record_function("x"):
            pass

    out = {"null_span_us": _per_call_us(null, n)}
    with obs.recording(), obs.span("sweep", root=True):
        out["recorded_span_us"] = _per_call_us(null, n)
    out["record_function_us"] = _per_call_us(pair, n)
    with profile(activities=[ProfilerActivity.CUDA]):
        out["record_function_cuda_only_us"] = _per_call_us(pair, n)
    obs.clear()
    return out


def split(frames) -> dict:
    """Median self ms a sweep of every span, and the spans a sweep."""
    from repro_torch import obs

    names = sorted({s.name for f in frames for s in f.spans})
    return {"self_ms": {n: statistics.median(obs.self_ms(f, n)
                                             for f in frames)
                        for n in names},
            "spans_a_sweep": statistics.median(len(f.spans)
                                               for f in frames)}


def measure(cell: dict, seed: int, sweeps: int, blocks: int) -> dict:
    import torch

    from repro_torch import obs

    torch.set_num_threads(1)
    inp = deployment.make(cell["config_doc"], cell["traffic_doc"], seed)
    traced = program.build_trace(inp)
    sweeper = program.Sweeper(inp, traced.trace, "cuda")
    sweeper.sweep(0)
    torch.cuda.synchronize()
    walls = {m: [] for m in MODES}
    frames = {m: [] for m in MODES if m != "untraced"}
    idle = []
    k = 1
    for _ in range(blocks):
        for mode in MODES:
            ks = range(k, k + sweeps)
            k += sweeps
            obs.clear()
            if mode == "cuda_only":
                dt = devtrace.trace_sweeps(sweeper.sweep, ks, host=False)
                walls[mode].append(dt.wall_s / sweeps * 1e3)
                idle.append(100.0 * (1.0 - dt.busy_s() / dt.window_s))
            else:
                t = time.perf_counter()
                with (obs.recording() if mode == "recording"
                      else contextlib.nullcontext()):
                    for j in ks:
                        sweeper.sweep(j)
                    torch.cuda.synchronize()
                walls[mode].append((time.perf_counter() - t) / sweeps * 1e3)
            if mode in frames:
                frames[mode] += obs.frames()
    obs.clear()
    out = {m: {"mean_sweep_ms": statistics.mean(walls[m]),
               "mean_sweep_ms_by_block": walls[m]} for m in MODES}
    for m, fs in frames.items():
        out[m].update(split(fs))
    out["cuda_only"]["device_idle_pct_by_block"] = idle
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--sweeps", type=int, default=run.TRACED_SWEEPS)
    ap.add_argument("--blocks", type=int, default=3)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("kvsimbench.spans: no CUDA device", file=sys.stderr)
        return 2
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(
        bench.ROOT / "build" / "repro_torch_kernels")
    sys.path.insert(0, str(bench.ROOT / "src"))
    result = {"workload": args.workload, "seed": args.seed,
              "card": run.card(), "torch": torch.__version__,
              **measure(bench.cell(args.workload), args.seed, args.sweeps,
                        args.blocks),
              "span_costs": span_costs()}
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
