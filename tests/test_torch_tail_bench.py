"""``benchmarks.tail_latency_bench_torch``: the smoke suite on the loop
backend is the reference's document (``benchmarks/tail_latency_bench.py``)
but for the ``host`` block, and on the port's torch grid on the host it
passes ``tools/check_bench.py`` unchanged."""
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmarks import tail_latency_bench as ref_bench
from benchmarks import tail_latency_bench_torch as bench
from repro_torch.core.sim import replay_torch as rt

ROOT = Path(__file__).resolve().parents[1]


def _cli(mod, argv, monkeypatch, name):
    monkeypatch.setattr("sys.argv", [name, *argv])
    mod.main()


def test_suites_and_protocol_equal_the_reference():
    assert bench.FULL == ref_bench.FULL and bench.SMOKE == ref_bench.SMOKE
    assert bench.LOAD_FRACS == ref_bench.LOAD_FRACS
    assert bench.SCHEMA == ref_bench.SCHEMA == "repro.tail_latency_bench/v1"


def test_loop_smoke_is_the_reference_document(tmp_path, monkeypatch):
    ref_out, port_out = tmp_path / "ref.json", tmp_path / "port.json"
    _cli(ref_bench, ["--smoke", "--out", str(ref_out)], monkeypatch,
         "tail_latency_bench")
    bench.main(["--smoke", "--backend", "loop", "--out", str(port_out)])
    want, got = (json.loads(p.read_text()) for p in (ref_out, port_out))
    assert sorted(got) == sorted(want) == [
        "backend", "entries", "host", "schema", "summary"]
    assert got.pop("host")["device"] == "host"
    want.pop("host")
    assert got == want
    assert all(e["source"] == "exact" for e in got["entries"])


def test_torch_smoke_on_the_host_passes_check_bench(tmp_path, monkeypatch):
    monkeypatch.setattr(rt, "_EXIT_CHECK_CHUNKS", 1)
    out = tmp_path / "tail.json"
    bench.main(["--smoke", "--device", "cpu", "--out", str(out)])
    doc = json.loads(out.read_text())
    assert doc["backend"] == "torch" and doc["host"]["device"] == "cpu"
    assert all(e["source"] == "hist" for e in doc["entries"])
    res = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "check_bench.py"), str(out)],
        capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_torch_without_a_card_exits_before_any_work(monkeypatch):
    def no_run(*a, **kw):
        raise AssertionError("a suite started without a device")

    monkeypatch.setattr(bench, "run_suite", no_run)
    with pytest.raises(SystemExit) as e:
        bench.main(["--smoke"])
    assert "--device cpu" in str(e.value.code)
