"""The harness on the CPU: ``BENCHMARK.json`` against the contract's shape,
every cell resolved to its files, the metric readers on a canned profiler
table, and the command's refusals (no GPU, no program)."""
import json
import re
import shutil
import subprocess
import sys

import pytest

from kvsimbench import bench, deployment, devtrace
from kvsimbench.metrics import sched_roofline_pct

DOC = bench.load()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in DOC["workloads"]]


def test_benchmark_keys_and_limits():
    assert set(DOC) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert DOC["paths"] == ["kvsimbench"]
    assert 1 <= DOC["run_seconds"] <= 51
    assert isinstance(DOC["run_seconds"], int)
    assert len(DOC["command"]) <= 32
    for m in DOC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in (
            "host_clock", "device_trace")
    assert [m for m in DOC["end_to_end"] if m["name"] == "setup_s"]
    chips4 = [w for w in DOC["workloads"] if w["chips"] == 4]
    assert len(chips4) <= max(1, len(CELLS) // 4)
    assert len(json.dumps(DOC)) < 64 * 1024


def test_names_units_and_text():
    names = ([c["name"] for c in DOC["configs"]] + CELLS
             + [m["name"] for m in DOC["end_to_end"] + DOC["per_layer"]])
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in DOC["workloads"]]:
        assert NAME.match(n), n
    for m in DOC["end_to_end"] + DOC["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for text in ([w["why"] for w in DOC["workloads"] + DOC["configs"]]
                 + [c["source"] for c in DOC["configs"]]
                 + [m["layer"] for m in DOC["per_layer"]] + DOC["command"]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves(cell):
    c = bench.cell(cell)
    cfg = next(x for x in DOC["configs"] if x["name"] == c["config"])
    assert (bench.ROOT / cfg["file"]).is_file()
    assert c["config_doc"]["name"] == c["config"]
    assert set(cfg["reduced"]) <= set(c["config_doc"]["reduced"])
    assert c["traffic_doc"]["name"] == c["traffic"]
    assert c["chips"] == 1
    e2e = {m["name"] for m in c["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c["per_layer"]
    for m in c["per_layer"]:
        assert m["moves"] in e2e
        assert callable(bench.metric_reader(m["name"]))
    inp = deployment.make(c["config_doc"], c["traffic_doc"], 2**33 + 7)
    assert len(inp.latencies) == 128 and inp.threads == [8, 16, 32, 64]
    assert inp.latencies[0] == pytest.approx(1e-7)
    assert inp.latencies[-1] == pytest.approx(1e-5)


def test_seeds_derive_from_the_seed():
    c = bench.cell("hash_fig_open")
    a = deployment.make(c["config_doc"], c["traffic_doc"], 3)
    b = deployment.make(c["config_doc"], c["traffic_doc"], 3)
    d = deployment.make(c["config_doc"], c["traffic_doc"], 4)
    assert (a.keys == b.keys).all() and not (a.keys == d.keys).all()
    assert a.engine_kwargs == b.engine_kwargs != d.engine_kwargs
    assert a.sweep_seed(5) == b.sweep_seed(5) != a.sweep_seed(6)
    assert a.arrival_for(1)["seed"] != a.arrival_for(2)["seed"]
    assert a.arrival_for(1)["rate"] == pytest.approx(0.9 * 408000.0)


# A canned profiler table: two sweeps' spans, three kernels, one copy, and
# the host's operators around the idle stretches.
EVENTS = [
    {"ph": "X", "cat": "user_annotation", "name": devtrace.SPAN,
     "ts": 0.0, "dur": 1000.0},
    {"ph": "X", "cat": "user_annotation", "name": devtrace.SPAN,
     "ts": 1000.0, "dur": 1000.0},
    {"ph": "X", "cat": "kernel", "name": "void sched_step_kernel<false>()",
     "ts": 100.0, "dur": 400.0},
    {"ph": "X", "cat": "kernel", "name": "void sched_step_kernel<false>()",
     "ts": 1100.0, "dur": 500.0},
    {"ph": "X", "cat": "kernel", "name": "elementwise", "ts": 450.0,
     "dur": 100.0},
    {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 1900.0,
     "dur": 50.0},
    {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 1650.0,
     "dur": 200.0},
    {"ph": "X", "cat": "cpu_op", "name": "aten::to", "ts": 1600.0,
     "dur": 300.0},
    {"ph": "i", "cat": "cpu_op", "name": "instant", "ts": 5.0},
]


def test_devtrace_on_a_canned_table():
    dt = devtrace.parse(EVENTS, 2, 0.002)
    assert dt.window == (0.0, 2000.0)
    assert dt.busy_s() == pytest.approx(1000e-6)   # 100-550, 1100-1600, 1900-1950
    assert dt.device_seconds("sched_step_kernel") == pytest.approx(900e-6)
    ops = dict(dt.top_device_ops())
    assert ops["void sched_step_kernel<false>()"] == pytest.approx(900e-6)
    gaps = dict(dt.idle_gaps())
    # idle: 0-100, 550-1100 and 1950-2000 inside spans only; 1600-1900
    # under aten::to with aten::copy_ innermost at its midpoint
    assert gaps["aten::copy_"] == pytest.approx(300e-6)
    assert gaps["python"] == pytest.approx(700e-6)
    assert sum(gaps.values()) == pytest.approx(2000e-6 - 1000e-6)


def test_metric_readers_on_a_canned_table():
    c = bench.cell("hash_fig_closed")
    inp = deployment.make(c["config_doc"], c["traffic_doc"], 1)

    class Trace:
        n_ops, n_subops = 21000, 111605

    dt = devtrace.parse(EVENTS, 2, 0.002)
    ctx = {"spans": {"trace_build": [0.25], "plan_grid": [0.01, 0.03, 0.02]},
           "dtrace": dt, "inputs": inp, "trace": Trace(),
           "window": {"seconds": 0.02, "sweeps": 4}}
    read = {m["name"]: bench.metric_reader(m["name"])(ctx)
            for m in c["per_layer"]}
    assert read["trace_build_s"] == 0.25
    assert read["plan_ms"] == pytest.approx(20.0)
    assert read["sched_kernel_ms"] == pytest.approx(0.45)
    # the traced window: 1000 us busy of 2000 us
    assert read["device_idle_pct"] == pytest.approx(50.0)
    b = sched_roofline_pct.sweep_bytes(21000, 111605, 128, [8, 16, 32, 64],
                                       5000, inp.sim, False)
    assert 3.0e8 < b < 4.5e8            # about 372 MB a sweep
    assert read["sched_roofline_pct"] == pytest.approx(
        100 * b / 3.35e12 / 450e-6)
    # a reader that finds nothing returns nothing, never 0
    empty = dict(ctx, dtrace=None, spans={})
    assert all(bench.metric_reader(m["name"])(empty) is None
               for m in c["per_layer"])


def test_open_loop_bytes_count_the_histograms():
    c = bench.cell("hash_fig_open")
    inp = deployment.make(c["config_doc"], c["traffic_doc"], 1)
    args = (21000, 111605, 128, inp.threads, 5000, inp.sim)
    extra = (sched_roofline_pct.sweep_bytes(*args, True)
             - sched_roofline_pct.sweep_bytes(*args, False))
    assert extra >= 512 * 2 * 513 * 8


def _cli(cwd, *args):
    return subprocess.run(
        [sys.executable, "-m", "kvsimbench.run", "--workload",
         "hash_fig_closed", "--seed", "1", "--seconds", "1", "--trace", "0",
         *args], cwd=cwd, capture_output=True, text=True, timeout=300)


def test_cli_refuses_without_a_gpu():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the refusal needs none")
    r = _cli(bench.ROOT)
    assert r.returncode != 0 and r.stdout.strip() == ""
    assert "no CUDA device" in r.stderr


def test_cli_refuses_without_the_program(tmp_path):
    shutil.copy(bench.BENCHMARK, tmp_path / "BENCHMARK.json")
    shutil.copytree(bench.HERE, tmp_path / "kvsimbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = _cli(tmp_path)
    assert r.returncode != 0 and r.stdout.strip() == ""


@pytest.mark.requires_cuda
def test_cli_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    r = _cli(bench.ROOT)
    assert r.returncode == 0, r.stderr[-2000:]
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert list(line)[-1] == "checks"
    assert set(line["metrics"]) == {"sim_ops_per_s", "sweep_p95_ms",
                                    "setup_s"}
