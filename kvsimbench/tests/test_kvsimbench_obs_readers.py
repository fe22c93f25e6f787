"""The readers of the program's spans and counters (``repro_torch.obs``) on
frames built by hand: nothing without a device trace or with too few
frames, and otherwise the median over the first ``n_sweeps`` frames (the
profile with CUDA activity alone) of each span's self time."""
from types import SimpleNamespace

import pytest

from kvsimbench import bench
from repro_torch import obs

READERS = ["prepare_ms", "plan_host_ms", "feed_ms", "launch_host_ms",
           "host_wait_ms", "reduce_ms", "assemble_ms", "steps_run_pct"]
MS = 1_000_000
# name, start ms, end ms, parent index: one sweep's spans at scale 1
SPANS = [("sweep", 0, 100, -1), ("sweep.prepare", 0, 2, 0),
         ("grid.plan", 2, 12, 0), ("grid.lower", 2, 4, 2),
         ("grid.cohorts", 4, 5, 2), ("grid.init", 5, 8, 2),
         ("grid.init", 8, 10, 2), ("grid.run", 12, 80, 0),
         ("grid.feed", 12, 14, 7), ("grid.launch", 14, 15, 7),
         ("grid.exit_read", 15, 20, 7), ("grid.feed", 20, 22, 7),
         ("grid.launch", 22, 23, 7), ("grid.readback", 70, 78, 7),
         ("grid.reduce", 80, 85, 0), ("sweep.assemble", 85, 90, 0),
         ("sweep.assemble", 95, 97, 0)]
# at scale 1: the self times each reader sums, and the step share
WANT = {"prepare_ms": 2.0, "plan_host_ms": 10.0, "feed_ms": 4.0,
        "launch_host_ms": 2.0, "host_wait_ms": 13.0, "reduce_ms": 5.0,
        "assemble_ms": 7.0}


def frame(i, scale, steps_run):
    return obs.Frame(i, [obs.Span(n, a * scale * MS, b * scale * MS, p, i)
                         for n, a, b, p in SPANS],
                     {"grid.steps_bound": 1000, "grid.steps_run": steps_run})


@pytest.fixture
def frames(monkeypatch):
    """Three profiled sweeps at scales 1, 4, 2 (median 2), then three of
    the host-activity profile, which no reader may use."""
    got = [frame(1, 1, 500), frame(2, 4, 900), frame(3, 2, 700)]
    got += [frame(4 + j, 100, 10) for j in range(3)]
    monkeypatch.setattr(obs, "frames", lambda: list(got))
    return got


def read(name, dtrace):
    return bench.metric_reader(name)({"dtrace": dtrace, "spans": {}})


@pytest.mark.parametrize("name", READERS)
def test_nothing_without_a_device_trace(frames, name):
    assert read(name, None) is None


@pytest.mark.parametrize("name", READERS)
def test_nothing_with_too_few_frames(frames, name):
    assert read(name, SimpleNamespace(n_sweeps=7)) is None


@pytest.mark.parametrize("name", sorted(WANT))
def test_median_of_self_times(frames, name):
    assert read(name, SimpleNamespace(n_sweeps=3)) == pytest.approx(
        2 * WANT[name])


def test_steps_run_share(frames):
    assert read("steps_run_pct", SimpleNamespace(n_sweeps=3)) == (
        pytest.approx(70.0))


def test_every_reader_is_declared_for_every_cell():
    doc = bench.load()
    cells = [w["name"] for w in doc["workloads"]]
    declared = {m["name"]: m for m in doc["per_layer"]}
    for name in READERS:
        m = declared[name]
        assert m["workloads"] == cells and m["moves"] == "sim_ops_per_s"
        assert m["source"] == "host_clock" and m["better"] == "lower"
