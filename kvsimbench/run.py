"""Run one cell of ``BENCHMARK.json`` on one NVIDIA GPU and print its line.

    python3 -m kvsimbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Set-up (``setup_s``, from the start of this process): the CUDA context, the
deployment's inputs from ``--seed``, the program's engine walk
(``run_trace``), and one warm-up sweep, which builds the CUDA kernels into
``build/repro_torch_kernels/`` of the checkout when they are missing.
Window: ``core.sim.sweep_latency(backend="torch")`` back to back for
``--seconds``, one caller waiting for each sweep; sweep ``k`` draws its own
scheduler and arrival seeds from ``--seed``.  With ``--trace 1`` a run then
times ``plan_grid`` and profiles twelve more sweeps with ``torch.profiler``
for the per-layer metrics: six with CUDA activity alone (kernel time, busy
and idle share), six with the host's operators too (the breakdown).  Last, with the program's state freed, ``check.py``
holds what the window produced against the plain reference.

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, ``breakdown`` with
``--trace 1``, and ``checks``, each number compared beside its limit, which
also end standard error).  Without a CUDA device, outside a checkout that
holds ``src/repro_torch``, or with JAX loaded once the window has closed,
the run prints no result and exits non-zero.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

from . import bench, check, deployment, devtrace, program  # noqa: E402

#: sweeps each of the ``--trace 1`` run's two profiles takes, and the
#: ``plan_grid`` calls it times
TRACED_SWEEPS = 6
PLAN_CALLS = 5
#: top-level module names that may not be loaded by the end of a run
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def nearest_rank(values, q: float) -> float:
    v = sorted(values)
    return v[max(math.ceil(q * len(v)) - 1, 0)]


def card() -> dict:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return {}
    return {"nvidia_smi": out[0]} if out else {}


def run(cell: dict, seed: int, seconds: float, trace: bool, device,
        overrides: dict | None = None, t_start: float | None = None) -> dict:
    """One run of ``cell``; the result line as a dict.  ``device`` is
    ``"cuda"`` from the command line (the tests pass ``"cpu"`` and small
    ``overrides``)."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    torch.set_num_threads(1)
    on_card = torch.device(device).type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    # -- set-up ----------------------------------------------------------
    split = {"imports": time.perf_counter() - t_start}
    t = time.perf_counter()
    if on_card:
        torch.cuda.init()
        torch.empty(1, device=device)
    split["cuda_context"] = time.perf_counter() - t
    t = time.perf_counter()
    inp = deployment.make(cell["config_doc"], cell["traffic_doc"], seed,
                          overrides)
    split["inputs"] = time.perf_counter() - t
    spans = {}
    t = time.perf_counter()
    traced = program.build_trace(inp)
    spans["trace_build"] = [time.perf_counter() - t]
    t = time.perf_counter()
    sweeper = program.Sweeper(inp, traced.trace, device)
    setup_errors = []
    try:
        sweeper.sweep(0)                  # warm-up: build, load, first use
    except Exception as e:                # the run is not correct
        setup_errors.append(f"warm-up sweep: {type(e).__name__}: {e}")
    sync()
    split["trace_build"] = spans["trace_build"][0]
    split["warmup_sweep"] = time.perf_counter() - t
    setup_s = time.perf_counter() - t_start

    # -- window ----------------------------------------------------------
    walls, done, errors = [], [], []
    k = 1
    w0 = time.perf_counter()
    while True:
        t = time.perf_counter()
        try:
            points = sweeper.sweep(k)
        except Exception as e:            # a failed sweep is counted
            points = None
            errors.append(f"sweep {k}: {type(e).__name__}: {e}")
        t_end = time.perf_counter()
        if points is not None:
            walls.append(t_end - t)
            done.append((k, check.compact(points)))
        k += 1
        if t_end - w0 >= seconds:
            break
    window_s = t_end - w0
    attempted = k - 1
    sync()
    peak = torch.cuda.max_memory_allocated() if on_card else 0

    cells = len(inp.latencies) * len(inp.threads)
    values = {
        "sim_ops_per_s": (len(done) * cells * inp.n_ops / window_s, "ops/s"),
        "sweep_p95_ms": ((nearest_rank(walls, 0.95) * 1e3 if walls
                          else math.nan), "ms"),
        "setup_s": (setup_s, "s"),
    }
    metrics = {m["name"]: {"value": values[m["name"]][0],
                           "unit": values[m["name"]][1]}
               for m in cell["end_to_end"]} if not trace else {}
    dev = {"platform": "gpu" if on_card else torch.device(device).type,
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    result = {}
    dtrace = htrace = None

    # -- per-layer metrics (--trace 1) -----------------------------------
    if trace:
        spans["plan_grid"] = []
        for j in range(PLAN_CALLS):
            plan = sweeper.plan(k + j)
            t = time.perf_counter()
            plan()
            sync()
            spans["plan_grid"].append(time.perf_counter() - t)
        if on_card:
            dtrace = devtrace.trace_sweeps(
                sweeper.sweep, range(k, k + TRACED_SWEEPS), host=False)
            k += TRACED_SWEEPS
            htrace = devtrace.trace_sweeps(
                sweeper.sweep, range(k, k + TRACED_SWEEPS), host=True)
        ctx = {"spans": spans, "dtrace": dtrace, "inputs": inp,
               "trace": traced.trace,
               "window": {"seconds": window_s, "sweeps": len(done)}}
        for m in cell["per_layer"]:
            v = bench.metric_reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        if dtrace is not None:
            dev["busy_s"] = dtrace.busy_s()
            dev["window_s"] = dtrace.window_s
            result["breakdown"] = {"device_ops": htrace.top_device_ops(),
                                   "idle_gaps": htrace.idle_gaps()}

    # -- the check, with the program's state freed -----------------------
    del sweeper
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    numbers = check.judge(inp, traced.trace, done) if done else {}
    correct = (bool(done) and not errors and not setup_errors
               and check.passed(numbers))
    walls_ms = sorted(w * 1e3 for w in walls)
    window = {"seconds": window_s, "sweeps": len(walls),
              "wall_ms_min_median_max": (
                  [walls_ms[0], walls_ms[len(walls_ms) // 2], walls_ms[-1]]
                  if walls_ms else []),
              "mean_sweep_ms": (sum(walls_ms) / len(walls_ms) if walls_ms
                                else None)}
    if dtrace is not None:
        window["traced_mean_sweep_ms"] = dtrace.wall_s / dtrace.n_sweeps * 1e3
    return {"correct": correct, "attempted": attempted,
            "failed": len(errors), "metrics": metrics, "device": dev,
            **result, "card": card() if on_card else {},
            "setup_split_s": split,
            "window": window,
            "errors": (setup_errors + errors)[:3], "checks": numbers}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    def fail(msg: str) -> int:
        print(f"kvsimbench: {msg}", file=sys.stderr, flush=True)
        return 2

    if not bench.BENCHMARK.is_file():
        return fail(f"{bench.BENCHMARK} is missing")
    src = bench.ROOT / "src"
    if not (src / "repro_torch").is_dir():
        return fail(f"the program is missing: no {src / 'repro_torch'}")
    cell = bench.cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        return fail("no CUDA device: the benchmark runs on an NVIDIA GPU "
                    "and has no CPU fallback")
    if torch.cuda.device_count() < cell["chips"]:
        return fail(f"the cell needs {cell['chips']} GPU(s), "
                    f"{torch.cuda.device_count()} visible")
    # the kernels build once per checkout, at a fixed path inside it
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(
        bench.ROOT / "build" / "repro_torch_kernels")
    sys.path.insert(0, str(src))
    result = run(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                 t_start=T_START)
    found = forbidden_modules()
    if found:
        return fail(f"JAX or the JAX package is loaded: {found}")
    for e in result["errors"]:
        print(f"kvsimbench: {e}", file=sys.stderr)
    print(f"kvsimbench: set-up {json.dumps(result['setup_split_s'])}",
          file=sys.stderr)
    print(f"kvsimbench: window {json.dumps(result['window'])}",
          file=sys.stderr)
    for name, n in result["checks"].items():
        print(f"check {name} = {n['value']!r} (limit {n['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
