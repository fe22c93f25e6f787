"""The slice as a whole: one scenario through ``Experiment.run`` in the
reference package (``backend="loop"`` and ``backend="jax"``) and in the port
(``device="cpu"``: the plain PyTorch step; and ``backend="loop"``).

Contracts: the trace statistics and calibrated model parameters (``S``,
``M``, ``T_mem_us``, ``hit_stats``, the model column) are identical -- the
same seeded host code; the loop backends of both packages are bit-identical;
the port's grid rows sit within ``grid_tol(n_ops)`` (1 % at 20 000 ops,
widened by ``sqrt(20000 / n_ops)``) of the loop, as the reference's own grid
does; a mixture-latency row is bit-identical to the loop; artifacts of both
packages share one JSON schema.
"""
import json
import subprocess
import sys
from pathlib import Path

import pytest

from repro.core import experiment as ref_ex
from repro_torch.core.conformance import grid_tol
from repro_torch.core import experiment as ex
from repro_torch.core.sim import SimConfig, sweep_latency
from repro_torch.core.sim import sweep as sweep_mod

from _torch_port_support import US, engine_trace

ROOT = Path(__file__).resolve().parents[1]
N_OPS = 500


def _doc(**over):
    doc = json.loads(
        (ROOT / "examples" / "scenarios" / "hash_index_2ssd.json").read_text())
    doc.update(n_keys=3000, n_wl_ops=900, n_ops=N_OPS, latencies_us=[1, 6],
               thread_candidates=[6, 8])
    doc.update(over)
    return doc


@pytest.fixture(scope="module")
def artifacts():
    port = ex.Experiment(ex.Scenario.from_dict(_doc()),
                         ex.RunOptions(device="cpu")).run()
    port_loop = ex.Experiment(ex.Scenario.from_dict(_doc()),
                              ex.RunOptions(backend="loop",
                                            processes=1)).run()
    ref_loop = ref_ex.Experiment(ref_ex.Scenario.from_dict(_doc()),
                                 ref_ex.RunOptions(backend="loop",
                                                   processes=1)).run()
    ref_jax = ref_ex.Experiment(ref_ex.Scenario.from_dict(_doc()),
                                ref_ex.RunOptions(backend="jax")).run()
    return port, port_loop, ref_loop, ref_jax


def test_trace_stats_and_model_identical(artifacts):
    port, port_loop, ref_loop, ref_jax = artifacts
    for fld in ("engine", "workload", "S", "M", "T_mem_us", "T_io_pre_us",
                "T_io_post_us", "hit_stats", "schema_version"):
        assert getattr(port, fld) == getattr(ref_loop, fld), fld
        assert getattr(port, fld) == getattr(ref_jax, fld), fld
    assert port.scenario.to_dict() == ref_loop.scenario.to_dict()
    for a, b in zip(port.rows, ref_loop.rows):
        assert a.L_us == b.L_us
        assert a.model_throughput == b.model_throughput


def test_loop_backends_bit_identical(artifacts):
    _, port_loop, ref_loop, _ = artifacts
    assert port_loop.to_dict() == ref_loop.to_dict()


def test_grid_rows_within_the_tolerance_law(artifacts):
    port, _, ref_loop, ref_jax = artifacts
    tol = grid_tol(N_OPS, slack=1.25)
    for a, b, c in zip(port.rows, ref_loop.rows, ref_jax.rows):
        loop = dict(b.per_thread)
        for n, thr in a.per_thread:
            assert abs(thr - loop[n]) / loop[n] < tol, (a.L_us, n)
        for n, thr in c.per_thread:       # the reference grid, same law
            assert abs(thr - loop[n]) / loop[n] < tol, (c.L_us, n)
        assert a.throughput == max(t for _, t in a.per_thread)


def test_artifact_json_round_trip_and_shared_schema(artifacts, tmp_path):
    port, port_loop, ref_loop, _ = artifacts
    assert ex.RunArtifact.from_json(port.to_json()) == port
    # either package reads the other's artifact
    assert ref_ex.RunArtifact.from_json(port.to_json()).to_dict() == \
        port.to_dict()
    assert ex.RunArtifact.from_json(ref_loop.to_json()).to_dict() == \
        ref_loop.to_dict()
    assert port.to_csv().splitlines()[0] == ref_loop.to_csv().splitlines()[0]
    a, b = tmp_path / "port.json", tmp_path / "ref.json"
    a.write_text(port_loop.to_json())
    b.write_text(ref_loop.to_json())
    out = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "artifact_diff.py"), str(a),
         str(b), "--exact"], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_mixture_row_bit_identical_to_loop():
    mix = [[5, 0.9], [50, 0.1]]
    doc = _doc(latencies_us=[2, mix], thread_candidates=[8], n_ops=200)
    port = ex.Experiment(ex.Scenario.from_dict(doc),
                         ex.RunOptions(device="cpu")).run()
    loop = ex.Experiment(ex.Scenario.from_dict(doc),
                         ex.RunOptions(backend="loop", processes=1)).run()
    assert port.rows[1].per_thread == loop.rows[1].per_thread
    assert port.rows[1].throughput == loop.rows[1].throughput
    assert port.rows[0].throughput != loop.rows[0].throughput


def test_torch_and_loop_cells_never_share_cache_entries(tmp_path):
    trace = engine_trace("hash-index").trace
    cfg = SimConfig(P=12, seed=7)
    kw = dict(n_ops=120, cache_dir=tmp_path)
    loop = sweep_latency(cfg, trace, [5 * US], (8,), backend="loop",
                         processes=1, **kw)
    n_loop = len(list(tmp_path.glob("*.json")))
    grid = sweep_latency(cfg, trace, [5 * US], (8,), device="cpu", **kw)
    assert len(list(tmp_path.glob("*.json"))) == 2 * n_loop == 2
    assert loop[0].throughput != grid[0].throughput
    # a second run is served from the cache, bit-identically
    again = sweep_latency(cfg, trace, [5 * US], (8,), device="cpu", **kw)
    assert again[0].throughput == grid[0].throughput
    assert len(list(tmp_path.glob("*.json"))) == 2


def test_code_salt_covers_the_ports_python_and_cuda_sources(monkeypatch):
    salt = sweep_mod._code_salt()
    assert len(salt) == 16 and salt == sweep_mod._code_salt()
    import hashlib
    import os
    real_open = open
    seen = []

    def spy(path, *a, **k):
        seen.append(os.fspath(path))
        return real_open(path, *a, **k)

    monkeypatch.setattr(sweep_mod, "_CODE_SALT", None)
    monkeypatch.setattr("builtins.open", spy)
    sweep_mod._code_salt()
    names = {os.path.basename(p) for p in seen}
    assert {"replay_torch.py", "sched_step.py", "token_clock.py",
            "sched_step.cu", "token_clock.cu", "token_clock.cuh",
            "trace_ir.py"} <= names
    assert all(f"{os.sep}repro_torch{os.sep}" in p for p in seen)


def test_sweep_latency_torch_backend_validation():
    trace = engine_trace("hash-index").trace
    cfg = SimConfig(P=12, seed=7)
    with pytest.raises(ValueError, match="backend must be one of"):
        sweep_latency(cfg, trace, [1 * US], (8,), backend="numpy")
    with pytest.raises(ValueError, match="adaptive"):
        sweep_latency(cfg, trace, [1 * US], (8,), adaptive=True,
                      device="cpu")
    with pytest.raises(ValueError, match="collection"):
        sweep_latency(cfg, trace, [1 * US], (8,), collect_latency=True,
                      device="cpu")
    with pytest.raises(ValueError, match="callable"):
        sweep_latency(cfg, lambda rng: None, [1 * US], (8,), device="cpu")


def test_open_loop_scenario_with_percentiles():
    doc = _doc(latencies_us=[2], thread_candidates=[8], n_ops=300,
               arrival={"kind": "poisson", "rate": 40e3, "seed": 1,
                        "deadline": 0.001})
    port = ex.Experiment(ex.Scenario.from_dict(doc),
                         ex.RunOptions(device="cpu",
                                       collect_percentiles=True)).run()
    loop = ref_ex.Experiment(ref_ex.Scenario.from_dict(doc),
                             ref_ex.RunOptions(backend="loop", processes=1,
                                               collect_percentiles=True)
                             ).run()
    t, r = port.rows[0].tail, loop.rows[0].tail
    assert t["source"] == "hist" and r["source"] == "exact"
    assert t["count"] + t["missed"] == 300
    assert t["offered_load"] == r["offered_load"]
    assert abs(t["p50_us"] - r["p50_us"]) / r["p50_us"] < 0.10
    assert abs(t["p99_us"] - r["p99_us"]) / r["p99_us"] < 0.15
    assert ex.RunArtifact.from_json(port.to_json()) == port
