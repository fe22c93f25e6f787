"""The grid's cell axis over devices (``host_devices``) and the training
launcher (``python -m repro_torch.launch.train``).

``host_devices=N`` splits each cohort's cells into N contiguous shards, one
per CUDA device; on the CPU the shards run one after another, so these
tests exercise the split, each shard's own early exit and the merge: every
result plane is bit-equal to one device.
"""
import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmarks import run_torch
from repro_torch.core import experiment as ex
from repro_torch.core.sim import SimConfig
from repro_torch.core.sim import replay_torch as rt

from _torch_port_support import US, engine_trace

ROOT = Path(__file__).resolve().parents[1]

PLANES = ("throughput", "time", "mem_stall_total", "mem_accesses", "p50",
          "p90", "p99", "lat_max", "lat_count", "missed", "lat_hist")


@pytest.fixture
def exit_every_chunk(monkeypatch):
    """Test the early exit after every chunk (results are bit-identical),
    so small cells stop after a chunk or two."""
    monkeypatch.setattr(rt, "_EXIT_CHECK_CHUNKS", 1)


@pytest.fixture(scope="module")
def hash_small():
    return engine_trace("hash-index").trace


def _grid(hash_small, n, **kw):
    cfg = SimConfig(P=12, seed=7, n_ssd=2, R_io=250e3)
    lats = [0.5 * US, 1 * US, 2 * US, 3 * US, 5 * US, 8 * US]
    return rt.sweep_grid(cfg, hash_small, lats, [2, 5, 6, 8], n_ops=40,
                         device="cpu", host_devices=n, **kw)


def test_host_devices_1_2_3_bit_equal_plane_for_plane(exit_every_chunk,
                                                      hash_small):
    """A 24-cell grid in two cohorts (thread buckets 2 and 8), its tail
    planes on, split into 1, 2 and 3 shards."""
    grids = {n: _grid(hash_small, n, collect_percentiles=True)
             for n in (1, 2, 3)}
    one = grids[1]          # host_devices=1: the default's path
    assert one.throughput.size == 24
    for n in (2, 3):
        g = grids[n]
        for name in PLANES:
            a, b = getattr(one, name), getattr(g, name)
            assert a is not None and np.array_equal(a, b, equal_nan=True), (
                n, name)
        assert (g.steps, g.cell_steps_bound) == (one.steps,
                                                 one.cell_steps_bound)
        assert g.cell_steps_run <= g.cell_steps_bound


def test_host_devices_refuses_a_count_below_one(hash_small):
    with pytest.raises(ValueError, match="host_devices must be >= 1"):
        _grid(hash_small, 0)


def _fleet_doc(n_ops=40):
    return dict(engine="hash-index", n_keys=1500, n_wl_ops=400, n_ops=n_ops,
                latencies_us=(1.0, 4.0), thread_candidates=(3, 4),
                cluster={"n_nodes": 2, "partition": "hash"},
                arrival={"kind": "poisson", "rate": 200e3, "seed": 3})


def test_sweep_cluster_host_devices_bit_equal(exit_every_chunk):
    """A 2-node fleet through the experiment API: every node's grid split
    into 2 and 3 shards gives the 1-shard rows."""
    sc = ex.Scenario(**_fleet_doc())
    rows = {}
    for n in (None, 2, 3):
        art = ex.Experiment(sc, ex.RunOptions(
            device="cpu", collect_percentiles=True, host_devices=n)).run()
        rows[n] = [(r.throughput, r.n_threads, r.per_thread, r.tail,
                    json.dumps(r.nodes, sort_keys=True)) for r in art.rows]
    assert len(rows[None]) == 2
    assert rows[2] == rows[None] and rows[3] == rows[None]


def test_run_torch_accepts_backend_host_devices(exit_every_chunk, tmp_path,
                                                capsys):
    from repro.core.experiment import default_scenario

    spec = tmp_path / "tiny.json"
    spec.write_text(default_scenario(
        "hash-index", n_ssd=2, name="tiny", n_keys=2000, n_wl_ops=500,
        latencies_us=(0.5, 4), thread_candidates=(4, 6),
        n_ops=60).to_json())
    outs = []
    for extra in ([], ["--backend-host-devices", "2"]):
        run_torch.main(["--device", "cpu", "--scenario", str(spec), *extra])
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] and outs[0].count("\n") > 1


@pytest.mark.requires_cuda
def test_host_devices_past_the_visible_cards_raises(hash_small):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    n = torch.cuda.device_count() + 1
    with pytest.raises(ValueError, match=f"{n - 1} CUDA device"):
        rt.sweep_grid(SimConfig(P=12), hash_small, [1 * US], [4], n_ops=60,
                      host_devices=n)


# -- the training launcher -----------------------------------------------------

def _options(parser: argparse.ArgumentParser) -> dict:
    return {a.dest: (tuple(a.option_strings), a.default, a.type,
                     tuple(a.choices) if a.choices else None)
            for a in parser._actions if a.dest != "help"}


def test_launch_train_options_are_the_reference_set_plus_device(monkeypatch):
    import repro.launch.train as ref_train
    from repro_torch.launch.train import build_parser

    class Captured(Exception):
        pass

    def capture(self, *a, **kw):
        raise Captured(self)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(Captured) as e:
        ref_train.main()
    monkeypatch.undo()
    want, got = _options(e.value.args[0]), _options(build_parser())
    assert set(got) == set(want) | {"device"}
    assert got["device"][:2] == (("--device",), None)
    for dest, (flags, default, typ, choices) in want.items():
        g = got[dest]
        assert g[0] == flags and g[2] == typ and g[3] == choices, dest
        if dest != "ckpt":          # the reference's /tmp; the port's TMPDIR
            assert g[1] == default, dest
    assert os.path.basename(got["ckpt"][1]) == "repro_ckpt"


def test_launch_train_runs_on_the_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "qwen2.5-3b", "--steps", "4", "--batch", "2", "--seq", "16",
         "--device", "cpu", "--ckpt", str(tmp_path / "ck")],
        capture_output=True, text=True, env=env, timeout=300, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 4
    for i, line in enumerate(lines):
        step, loss, gnorm, wall = line.split()[1:]
        assert int(step) == i
        assert np.isfinite(float(loss.split("=")[1]))
        assert float(gnorm.split("=")[1]) > 0
        assert wall.startswith("wall=") and wall.endswith("s")
    assert (tmp_path / "ck" / "step_4" / "manifest.json").exists()
