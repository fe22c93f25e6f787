"""The comparison that decides ``correct``.

What the window produced is held against the plain reference
(``reference/``), which works everything out again from the run's inputs:

``trace_gap``
    Entries of the program's trace (kinds, CPU times, op bounds) that
    differ from the reference engine's trace of the same keys.  Exact:
    limit 0.
``value_gap``
    The largest relative gap, over a sample of latency rows drawn from the
    seed, between a sweep's point and the reference's: every thread
    count's throughput, and the chosen cell's elapsed time, memory stall,
    and (open loop) its p50 / p90 / p99 / max sojourn.  The program is held
    bit for bit; the limit leaves room for one ulp of a logarithm or a
    power.
``count_gap``
    Integer disagreements: on the sampled rows the chosen thread count, the
    chosen cell's memory accesses, recorded and missed ops; on every point
    of every sweep of the window, a chosen thread count that is not the
    first best of its row, a chosen result that is not that cell's, or a
    throughput that is not finite and positive.  Exact: limit 0.

The sample is one row from each sixteenth of the latency axis (64 of the
512 cells), each from a sweep of the window drawn from the seed.
"""
from __future__ import annotations

import math

import numpy as np

from .deployment import Inputs
from .reference import arrivals as ref_arrivals
from .reference import engines as ref_engines
from .reference import trace as ref_trace
from .reference.scheduler import run_cell

#: number -> limit (readings in PERF.md)
LIMITS = {"trace_gap": 0, "value_gap": 1e-8, "count_gap": 0}
SAMPLE_BANDS = 16


def compact(points) -> dict:
    """A sweep's points as arrays (what the check reads of them)."""
    n = len(points)
    out = dict(best=np.empty(n, np.int64),
               per_thread=np.empty((n, len(points[0].per_thread))),
               win=np.empty((n, 3)), win_int=np.empty((n, 2), np.int64),
               tail=np.full((n, 4), np.nan), tail_count=np.zeros(n, np.int64))
    for i, p in enumerate(points):
        r = p.result
        out["best"][i] = p.n_threads
        out["per_thread"][i] = [p.per_thread[c] for c in sorted(p.per_thread)]
        out["win"][i] = (r.throughput, r.time, r.mem_stall_total)
        out["win_int"][i] = (r.mem_accesses, r.missed_ops)
        s = r.latency_summary
        if s is not None:
            out["tail"][i] = (s.p50, s.p90, s.p99, s.max)
            out["tail_count"][i] = s.count
    return out


def reduction_faults(sw: dict, threads: list) -> int:
    """Points of one sweep whose choice or values are inconsistent."""
    thr = sw["per_thread"]
    first_best = np.argmax(thr, axis=1)      # first index of the maximum
    chosen = np.asarray(threads)[first_best]
    bad = (sw["best"] != chosen)
    bad |= sw["win"][:, 0] != thr[np.arange(len(thr)), first_best]
    bad |= ~np.all(np.isfinite(thr) & (thr > 0), axis=1)
    return int(bad.sum())


def sample_rows(seed: int, n_sweeps: int, n_lat: int) -> list[tuple]:
    """``(sweep, row)`` pairs: one row in each of ``SAMPLE_BANDS`` equal
    stretches of the latency axis, each of a sweep drawn from the seed."""
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), 5]))
    edges = np.linspace(0, n_lat, SAMPLE_BANDS + 1).round().astype(int)
    return [(int(rng.integers(n_sweeps)), int(rng.integers(lo, hi)))
            for lo, hi in zip(edges[:-1], edges[1:]) if hi > lo]


def reference_trace(inp: Inputs, real=float):
    store = ref_engines.get(inp.config["engine"])(inp.config["n_keys"],
                                                  **inp.engine_kwargs)
    tr, stats = ref_trace.run_trace(store, inp.keys, inp.is_write,
                                    inp.config["warmup_frac"])
    if real is not float:
        tr = ref_trace.Trace(tr.kinds, np.asarray(
            tr.durs, dtype=np.float32).astype(np.float64), tr.bounds)
    return tr, stats


def trace_gap(tr, ref) -> int:
    gap = 0
    for a, b in ((tr.kinds, ref.kinds), (tr.durs, ref.durs),
                 (tr.bounds, ref.bounds)):
        a, b = np.asarray(a), np.asarray(b)
        n = min(len(a), len(b))
        gap += abs(len(a) - len(b)) + int(np.sum(a[:n] != b[:n]))
    return gap


def reference_row(inp: Inputs, tr, k: int, row: int, real=float) -> dict:
    """The reference's point at latency ``row`` of sweep ``k``, as a
    one-row ``compact`` dict."""
    spec = inp.arrival_for(k)
    arr = (ref_arrivals.get(spec["kind"])(spec, inp.arrival_count())
           if spec else None)
    sim = dict(inp.sim, deadline=spec["deadline"] if spec else 0.0)
    collect = bool(inp.traffic.get("collect_percentiles", False))
    cells = [run_cell(tr, sim, inp.latencies[row], t, inp.n_ops,
                      inp.sweep_seed(k), arrivals=arr, collect=collect,
                      real=real) for t in inp.threads]
    thr = [c.throughput for c in cells]
    j = min(range(len(cells)), key=lambda i: (-thr[i], i))
    w = cells[j]
    s = w.summary()
    return dict(best=np.array([inp.threads[j]]), per_thread=np.array([thr]),
                win=np.array([(w.throughput, w.time, w.mem_stall_total)]),
                win_int=np.array([(w.mem_accesses, w.missed)]),
                tail=np.array([(s["p50"], s["p90"], s["p99"], s["max"]) if s
                               else (math.nan,) * 4]),
                tail_count=np.array([s["count"] if s else 0]))


def rel_gap(a: float, b: float) -> float:
    a, b = float(a), float(b)
    if a == b or (math.isnan(a) and math.isnan(b)):
        return 0.0
    if b == 0.0 or math.isnan(a) or math.isnan(b):
        return math.inf
    return abs(a - b) / abs(b)


def compare_row(got: dict, row: int, want: dict) -> tuple[float, int]:
    """``(value gap, count gap)`` of row ``row`` of ``got`` against the
    reference's one-row ``want``."""
    pairs = []
    for key in ("per_thread", "win", "tail"):
        pairs += list(zip(got[key][row], want[key][0]))
    value = max(rel_gap(a, b) for a, b in pairs)
    count = int(got["best"][row] != want["best"][0])
    count += sum(abs(int(a) - int(b))
                 for a, b in zip(got["win_int"][row], want["win_int"][0]))
    count += abs(int(got["tail_count"][row]) - int(want["tail_count"][0]))
    return value, count


def judge(inp: Inputs, trace, sweeps: list[tuple[int, dict]]) -> dict:
    """The numbers compared, each ``{"value", "limit"}``.  ``trace`` is the
    program's trace and ``sweeps`` the window's completed sweeps as
    ``(k, compact(points))`` pairs, ``k`` the sweep's index in the
    window."""
    ref_tr, _ = reference_trace(inp)
    value, count = 0.0, 0
    for _, sw in sweeps:
        count += reduction_faults(sw, inp.threads)
    for i, row in sample_rows(inp.seed, len(sweeps), len(inp.latencies)):
        k, sw = sweeps[i]
        v, c = compare_row(sw, row, reference_row(inp, ref_tr, k, row))
        value = max(value, v)
        count += c
    got = {"trace_gap": trace_gap(trace, ref_tr), "value_gap": value,
           "count_gap": count}
    return {k: {"value": got[k], "limit": LIMITS[k]} for k in LIMITS}


def passed(numbers: dict) -> bool:
    return all(n["value"] <= n["limit"] for n in numbers.values())
