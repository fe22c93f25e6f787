"""``python -m benchmarks.run_torch`` against the reference CLI
(``benchmarks.run``): the same registry listings, the same bytes on the loop
backend, the torch grid within the backend contract, the same argument
checks and messages, and the port's own refusals (the reference's jax-only
flags; a torch sweep without its device)."""
import json
import random
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import benchmarks.run as ref_run
from benchmarks import common_torch
from benchmarks import run_torch
from repro.core.experiment import default_scenario
from repro_torch.core.conformance import grid_tol
from repro_torch.core.sim import SimConfig, microbenchmark_source, sweep_latency
from repro_torch.core.sim import replay_torch as rt
from repro_torch.core.sim import sweep as port_sweep

ROOT = Path(__file__).resolve().parents[1]
SUITE = ROOT / "examples" / "scenarios"

# tests/test_experiment.py's cheap scenario (hash-index is the fastest tracer)
SMALL = dict(n_keys=20_000, n_wl_ops=8_000, latencies_us=(0.1, 5),
             thread_candidates=(16, 24), n_ops=1500)


@pytest.fixture(autouse=True)
def _fresh_cli_state(monkeypatch):
    """Each CLI run sets the module-level settings of ``common_torch``;
    restore them after the test, and keep CPU grids short (the early exit
    tested every chunk: cell values do not depend on it)."""
    for name in ("SWEEP_PROCESSES", "SWEEP_CACHE", "BACKEND", "DEVICE"):
        monkeypatch.setattr(common_torch, name, getattr(common_torch, name))
    monkeypatch.setattr(rt, "_EXIT_CHECK_CHUNKS", 1)


def _ref(argv, capsys, monkeypatch):
    """The reference CLI: ``(stdout, stderr, exit message or None)``."""
    monkeypatch.setattr("sys.argv", ["benchmarks.run", *argv])
    try:
        ref_run.main()
        code = None
    except SystemExit as e:
        code = e.code
    out = capsys.readouterr()
    return out.out, out.err, code


def _port(argv, capsys):
    try:
        run_torch.main(list(argv))
        code = None
    except SystemExit as e:
        code = e.code
    out = capsys.readouterr()
    return out.out, out.err, code


@pytest.fixture
def small_spec(tmp_path):
    spec = tmp_path / "tiny.json"
    spec.write_text(default_scenario("hash-index", n_ssd=2, name="tiny",
                                     **SMALL).to_json())
    return spec


@pytest.mark.parametrize("flag", ["--list-engines", "--list-workloads",
                                  "--list-cluster-scenarios"])
def test_list_flags_equal_the_reference(flag, capsys, monkeypatch):
    want = _ref([flag], capsys, monkeypatch)
    got = _port([flag], capsys)
    assert got == want and want[2] is None and want[0].strip()


def test_loop_scenario_is_byte_identical(small_spec, tmp_path, capsys,
                                         monkeypatch):
    a_ref, a_port = tmp_path / "ref.json", tmp_path / "port.json"
    want = _ref(["--scenario", str(small_spec), "--artifact", str(a_ref)],
                capsys, monkeypatch)
    got = _port(["--backend", "loop", "--scenario", str(small_spec),
                 "--artifact", str(a_port)], capsys)
    assert want[2] is None and got[2] is None
    assert got[0] == want[0] and "scenario/tiny/summary" in got[0]
    assert a_port.read_bytes() == a_ref.read_bytes()


def test_torch_scenario_within_grid_tol_of_the_reference_loop(
        small_spec, tmp_path, capsys, monkeypatch):
    a_ref, a_port = tmp_path / "ref.json", tmp_path / "port.json"
    _ref(["--scenario", str(small_spec), "--artifact", str(a_ref)],
         capsys, monkeypatch)
    got = _port(["--device", "cpu", "--scenario", str(small_spec),
                 "--artifact", str(a_port)], capsys)
    assert got[2] is None
    ref_rows = json.loads(a_ref.read_text())["rows"]
    rows = json.loads(a_port.read_text())["rows"]
    tol = grid_tol(SMALL["n_ops"])
    cells = 0
    for r, p in zip(ref_rows, rows, strict=True):
        assert r["L_us"] == p["L_us"]
        for (n, want), (m, have) in zip(r["per_thread"], p["per_thread"],
                                        strict=True):
            assert n == m and abs(have - want) / want <= tol, (n, have, want)
            cells += 1
    assert cells == 4


def _diff_and_check(base, fresh):
    diff = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "artifact_diff.py"), "--exact",
         str(base), str(fresh)], capture_output=True, text=True, timeout=120)
    check = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "check_bench.py"), str(fresh)],
        capture_output=True, text=True, timeout=120)
    return diff, check


def test_loop_suite_matches_the_reference_suite(tmp_path, capsys,
                                                monkeypatch):
    ref_doc, port_doc = tmp_path / "ref.json", tmp_path / "port.json"
    want = _ref(["--suite", str(SUITE), "--suite-out", str(ref_doc)],
                capsys, monkeypatch)
    got = _port(["--backend", "loop", "--suite", str(SUITE), "--suite-out",
                 str(port_doc)], capsys)
    assert got[0] == want[0] and got[2] is None
    diff, check = _diff_and_check(ref_doc, port_doc)
    assert diff.returncode == 0, diff.stdout + diff.stderr
    assert check.returncode == 0, check.stdout + check.stderr
    doc = json.loads(port_doc.read_text())
    assert doc["schema"] == "repro.scenario_suite/v1"
    assert doc["backend"] == "loop" and doc["summary"]["n_scenarios"] == 3


def test_second_run_is_served_from_the_sweep_cache(small_spec, tmp_path,
                                                   capsys, monkeypatch):
    cache = tmp_path / "cache"
    argv = ["--backend", "loop", "--processes", "1", "--sweep-cache",
            str(cache), "--scenario", str(small_spec)]
    first = _port(argv, capsys)
    cells = sorted(p.name for p in cache.glob("*.json"))
    assert len(cells) == 4

    def no_sim(*a, **kw):
        raise AssertionError("a cell was simulated, not served from the cache")

    monkeypatch.setattr(port_sweep, "_run_cell", no_sim)
    second = _port(argv, capsys)
    assert second[0] == first[0] and first[2] is None and second[2] is None
    assert sorted(p.name for p in cache.glob("*.json")) == cells


def _error_cases(tmp_path):
    bad = tmp_path / "bad.json"
    bad.write_text('{"engine": "lsm", "bogus_field": 1}')
    unknown = tmp_path / "unknown.json"
    unknown.write_text('{"engine": "hash-idx"}')
    empty = tmp_path / "empty"
    empty.mkdir()
    broken = tmp_path / "broken"
    broken.mkdir()
    (broken / "a.json").write_text("{not json")
    cache = str(tmp_path / "cache")
    return {
        "clear-needs-cache": ["--sweep-cache-clear"],
        "prune-needs-cache": ["--sweep-cache-prune", "5"],
        "prune-days-needs-cache": ["--sweep-cache-prune-days", "1"],
        "prune-negative": ["--sweep-cache", cache, "--sweep-cache-prune",
                           "-1"],
        "prune-days-negative": ["--sweep-cache", cache,
                                "--sweep-cache-prune-days", "-1"],
        "arrival-needs-rate": ["--arrival", "poisson"],
        "rate-positive": ["--arrival", "poisson", "--rate", "0"],
        "rate-needs-arrival": ["--rate", "5"],
        "burst-needs-arrival": ["--burst", "0.5"],
        "burst-only-bursty": ["--arrival", "poisson", "--rate", "5",
                              "--burst", "0.5"],
        "burst-range": ["--arrival", "bursty", "--rate", "5", "--burst", "2"],
        "nodes-positive": ["--nodes", "0"],
        "replicas-range": ["--nodes", "2", "--replicas", "3"],
        "route-latency-positive": ["--nodes", "2", "--route-latency", "-1"],
        "replicas-need-nodes": ["--replicas", "2"],
        "route-latency-needs-nodes": ["--route-latency", "1"],
        "suite-exclusive": ["--suite", str(SUITE), "--engine", "lsm"],
        "suite-no-overlay": ["--suite", str(SUITE), "--nodes", "2"],
        "suite-out-needs-suite": ["--suite-out", "x.json"],
        "suite-empty": ["--suite", str(empty)],
        "suite-bad-spec": ["--suite", str(broken)],
        "scenario-missing": ["--scenario", str(tmp_path / "none.json")],
        "scenario-bad-spec": ["--scenario", str(bad)],
        "scenario-unknown-engine": ["--scenario", str(unknown)],
        "engine-unknown": ["--engine", "nope"],
        "devices-positive": ["--engine", "lsm", "--devices", "0"],
        "cores-positive": ["--engine", "lsm", "--cores", "0"],
    }


_ERROR_NAMES = [
    "clear-needs-cache", "prune-needs-cache", "prune-days-needs-cache",
    "prune-negative", "prune-days-negative", "arrival-needs-rate",
    "rate-positive", "rate-needs-arrival", "burst-needs-arrival",
    "burst-only-bursty", "burst-range", "nodes-positive", "replicas-range",
    "route-latency-positive", "replicas-need-nodes",
    "route-latency-needs-nodes", "suite-exclusive", "suite-no-overlay",
    "suite-out-needs-suite", "suite-empty", "suite-bad-spec",
    "scenario-missing", "scenario-bad-spec", "scenario-unknown-engine",
    "engine-unknown", "devices-positive", "cores-positive"]


@pytest.mark.parametrize("case", _ERROR_NAMES)
def test_argument_errors_exit_with_the_reference_message(case, tmp_path,
                                                         capsys, monkeypatch):
    cases = _error_cases(tmp_path)
    assert sorted(cases) == sorted(_ERROR_NAMES)
    argv = cases[case]
    want = _ref(argv, capsys, monkeypatch)
    # the port's default backend (torch), asked to run on the host
    got = _port([*argv, "--device", "cpu"], capsys)
    assert isinstance(want[2], str) and want[2]
    assert got[2] == want[2]
    assert got[0] == want[0]


@pytest.mark.parametrize("argv", [
    ["--backend-pallas"], ["--backend-unroll", "2"],
    # --backend-host-devices is accepted now; --backend-unroll beside it
    # is still refused
    ["--backend-host-devices", "2", "--backend-unroll", "2"],
    ["--backend", "jax"]])
def test_reference_only_flags_are_refused(argv, capsys):
    with pytest.raises(SystemExit) as e:
        run_torch.main(argv)
    assert e.value.code == 2
    assert "error:" in capsys.readouterr().err


@pytest.mark.parametrize("flag", ["--adaptive", "--collect-latency"])
def test_loop_only_options_on_torch_exit_with_the_sweep_message(
        flag, small_spec, capsys):
    """As the reference exits with its sweep's ``ValueError`` for
    ``--backend jax``, the port exits with its own for ``--backend torch``
    (``repro_torch/core/sim/sweep.py``)."""
    got = _port(["--device", "cpu", "--scenario", str(small_spec), flag],
                capsys)
    op = microbenchmark_source(2, 1e-7, 1e-6, 1e-7)(random.Random(0))
    with pytest.raises(ValueError) as e:
        sweep_latency(SimConfig(), [op], [1e-6], [4], backend="torch",
                      device="cpu", **{flag[2:].replace("-", "_"): True})
    assert got[2] == str(e.value) and "loop" in got[2]


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_torch_backend_without_a_card_exits_before_any_work(
        small_spec, capsys, monkeypatch):
    def no_run(*a, **kw):
        raise AssertionError("an experiment started without a device")

    monkeypatch.setattr(run_torch, "run_scenario_cmd", no_run)
    monkeypatch.setattr(run_torch, "run_suite_cmd", no_run)
    for argv in (["--scenario", str(small_spec)], ["--suite", str(SUITE)],
                 ["--only", "fig3"]):
        out, _, code = _port(argv, capsys)
        assert out == "" and isinstance(code, str)
        assert "--device cpu" in code and "--backend loop" in code


def test_device_cpu_leaves_the_kernel_rows_out(capsys):
    out, _, code = _port(["--device", "cpu", "--only", "kernels"], capsys)
    assert code is None
    lines = out.splitlines()
    assert lines[0] == "name,us_per_call,derived"
    assert lines[1].startswith("kernels/all,0.0000,left_out=device cpu")
    assert lines[2].startswith("bench/kernels_bench_torch/wall,")
    assert len(lines) == 3
