"""The port's spans and counters (``repro_torch.obs``) on the CPU: the off
path, nesting and self times, the span tree of one ``sweep_latency`` call
with the step counters of its ``GridResult``, open and closed loop, the
spans in a ``torch.profiler`` export, and thread-local parents.

The sweeps step 64-step chunks and test the early exit after every chunk,
so a grid of 5 ops a cell stops after a chunk or two."""
import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import pytest
from torch.profiler import ProfilerActivity, profile

from repro_torch import obs
from repro_torch.core.engines import get_engine, run_trace
from repro_torch.core.sim import SimConfig, sweep_latency
from repro_torch.core.sim import replay_torch as rt
from repro_torch.core.workloads import create_workload

SRC = Path(__file__).resolve().parents[1] / "src"
US = 1e-6
CFG = SimConfig(P=4, seed=7, n_ssd=2, R_io=250e3, L_switch=0.3 * US)
ARRIVAL = {"kind": "poisson", "rate": 2e5, "seed": 3}
CHUNK = 64
CELLS = 4
# (span, parent) of one sweep of one cohort, a chunk at a time
HEAD = [("sweep", None), ("sweep.prepare", "sweep"),
        ("sweep.prepare", "sweep"), ("sweep.prepare", "sweep"),
        ("grid.plan", "sweep"),
        ("grid.lower", "grid.plan"), ("grid.cohorts", "grid.plan"),
        ("grid.init", "grid.plan"), ("grid.run", "sweep")]
STEP = [("grid.feed", "grid.run"), ("grid.launch", "grid.run"),
        ("grid.exit_read", "grid.run")]
TAIL = [("grid.readback", "grid.run"), ("grid.reduce", "sweep"),
        ("sweep.assemble", "sweep"), ("sweep.assemble", "sweep")]


def tree(frame):
    """The span tree of a sweep that ran ``steps_run / CELLS / CHUNK``
    chunks, each tested for the early exit."""
    chunks = frame.counters["grid.steps_run"] // (CELLS * CHUNK)
    assert chunks >= 1
    return HEAD + STEP * chunks + TAIL


@pytest.fixture(scope="module")
def trace():
    return run_trace(get_engine("hash-index")(2000),
                     create_workload("uniform", 2000, 300)).trace


@pytest.fixture
def sweep(monkeypatch, trace):
    """``sweep(arrival)``: a 2 x 2 grid of 5 ops a cell, one cohort; the
    ``GridResult`` of its ``sweep_grid`` call."""
    monkeypatch.setattr(rt, "_RNG_CHUNK", CHUNK)
    monkeypatch.setattr(rt, "_EXIT_CHECK_CHUNKS", 1)
    grids, sweep_grid = [], rt.sweep_grid
    monkeypatch.setattr(rt, "sweep_grid", lambda *a, **k: grids.append(
        sweep_grid(*a, **k)) or grids[-1])
    obs.clear()

    def run(arrival=None):
        sweep_latency(CFG, trace, [1 * US, 5 * US], [3, 4], n_ops=5,
                      backend="torch", device="cpu", arrival=arrival,
                      collect_percentiles=arrival is not None)
        return grids[-1]
    yield run
    obs.clear()


def edges(frame):
    return [(s.name, frame.spans[s.parent].name if s.parent >= 0 else None)
            for s in frame.spans]


def test_off_path_records_nothing(sweep):
    assert obs.span("grid.launch") is obs.span("sweep", root=True)
    assert obs.span("grid.launch") is obs._NULL
    obs.count("grid.steps_run", 3)
    sweep()
    assert obs.frames() == []


def test_nesting_parents_and_self_times():
    obs.clear()
    with obs.recording():
        assert obs.span("outside") is obs._NULL    # no open sweep
        with obs.span("sweep", root=True):
            with obs.span("a"):
                with obs.span("b"):
                    obs.count("n", 2)
                with obs.span("b"):
                    obs.count("n", 3)
            with obs.span("a"):
                pass
    (f,) = obs.frames()
    assert edges(f) == [("sweep", None), ("a", "sweep"), ("b", "a"),
                        ("b", "a"), ("a", "sweep")]
    assert f.counters == {"n": 5} and {s.sweep for s in f.spans} == {f.sweep}
    for s in f.spans[1:]:
        p = f.spans[s.parent]
        assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
    # self time by hand: 0-100 ms sweep, a 10-60 (b 20-30, b 40-45), a 70-80
    ms = 1_000_000
    f.spans[:] = [obs.Span("sweep", 0, 100 * ms, -1, f.sweep),
                  obs.Span("a", 10 * ms, 60 * ms, 0, f.sweep),
                  obs.Span("b", 20 * ms, 30 * ms, 1, f.sweep),
                  obs.Span("b", 40 * ms, 45 * ms, 1, f.sweep),
                  obs.Span("a", 70 * ms, 80 * ms, 0, f.sweep)]
    assert obs.self_ms(f, "sweep") == pytest.approx(40.0)
    assert obs.self_ms(f, "a") == pytest.approx(45.0)
    assert obs.self_ms(f, "b") == pytest.approx(15.0)
    assert obs.self_ms(f, "missing") == 0.0
    obs.clear()


@pytest.mark.parametrize("arrival", [None, ARRIVAL], ids=["closed", "open"])
def test_sweep_span_tree_and_step_counters(sweep, arrival):
    with obs.recording():
        grid = sweep(arrival)
    (f,) = obs.frames()
    assert edges(f) == tree(f)
    for s in f.spans[1:]:
        p = f.spans[s.parent]
        assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns, s.name
    assert grid.cell_steps_run < grid.cell_steps_bound      # it exited
    assert f.counters == {"grid.steps_bound": grid.cell_steps_bound,
                          "grid.steps_run": grid.cell_steps_run}


def test_profiler_exports_the_spans_nested(sweep, tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sweep()
    (f,) = obs.frames()               # the profiler turned recording on
    assert edges(f) == tree(f)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    names = {n for n, _ in HEAD + STEP + TAIL}
    ev = sorted((e for e in json.loads(path.read_text())["traceEvents"]
                 if e.get("cat") == "user_annotation" and e["name"] in names),
                key=lambda e: (e["ts"], -e["dur"]))
    assert [e["name"] for e in ev] == [s.name for s in f.spans]
    for s, e in zip(f.spans[1:], ev[1:]):
        p = ev[s.parent]
        assert p["ts"] <= e["ts"] and e["ts"] + e["dur"] <= p["ts"] + p["dur"]


def test_grid_alone_is_not_annotated(trace, monkeypatch):
    """A ``sweep_grid`` call outside a sweep (as the fleet and the split
    benches make it) leaves a profile as it was: no span, no frame."""
    monkeypatch.setattr(rt, "_RNG_CHUNK", CHUNK)
    monkeypatch.setattr(rt, "_EXIT_CHECK_CHUNKS", 1)
    obs.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert obs.span("grid.plan") is obs._NULL
        obs.count("grid.steps_run", 1)
        rt.sweep_grid(CFG, trace, [1 * US], [3], n_ops=5, device="cpu")
    assert obs.frames() == []
    names = {n for n, _ in HEAD + STEP + TAIL}
    assert not [e for e in prof.events() if e.name in names]


def test_parent_stacks_are_thread_local():
    obs.clear()
    started, release = threading.Event(), threading.Event()

    def worker():
        with obs.span("worker"):
            started.set()
            release.wait(10)

    with obs.recording(), obs.span("sweep", root=True):
        with obs.span("main"):
            t = threading.Thread(target=worker)
            t.start()
            assert started.wait(10)
            with obs.span("inner"):
                pass
            release.set()
            t.join(10)
    assert not t.is_alive()
    (f,) = obs.frames()
    # the worker's span joins the open sweep with no parent; the main
    # thread's nesting is its own
    assert sorted(edges(f)) == sorted([("sweep", None), ("main", "sweep"),
                                       ("worker", None), ("inner", "main")])
    obs.clear()


def test_spans_need_no_torch_import():
    """``obs`` imports nothing heavy: the loop backend's sweep module still
    leaves torch out of a fresh process."""
    code = ("import sys, repro_torch.core.sim.sweep; "
            "print('torch' in sys.modules)")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True, env=env)
    assert out.stdout.strip() == "False"
