"""``benchmarks.torch_grid_bench``: the reference bench's cells
(``benchmarks/jax_grid_bench.py``), its smoke suite on the host through the
port's torch grid, and ``validate`` / ``floors`` of the port's own schema."""
import argparse
import copy

import pytest

from benchmarks import jax_grid_bench as ref_bench
from benchmarks import torch_grid_bench as bench
from repro_torch.core.sim import replay_torch as rt


@pytest.mark.parametrize("suite", bench.SUITES)
def test_suite_cells_equal_the_reference(suite):
    args = argparse.Namespace(n_keys=30_000, n_wl_ops=10_000, n_ops=5000)
    want = ref_bench._suite_specs(suite, args)
    got = bench._suite_specs(suite)
    assert got == want
    if suite == "mega":
        assert sum(len(s[4]) * len(s[5]) for s in got) == 4096


def test_unknown_suite_is_refused():
    with pytest.raises(SystemExit, match="unknown suite"):
        bench._suite_specs("nope")


@pytest.fixture(scope="module")
def smoke_doc():
    mp = pytest.MonkeyPatch()
    mp.setattr(rt, "_EXIT_CHECK_CHUNKS", 1)
    try:
        yield bench.run(["smoke"], reps=1, device="cpu")
    finally:
        mp.undo()


def test_smoke_on_the_host_passes_validate(smoke_doc):
    (e,) = smoke_doc["entries"]
    assert bench.validate(smoke_doc) and bench.over_bound(smoke_doc) == []
    assert e["cells"] == 8 and e["n_ops"] == 800
    assert e["worst_rel_bound"] == pytest.approx(0.05)
    assert 0 < e["worst_rel"] <= e["worst_rel_bound"]
    assert 0 < e["loop_reseed_worst_rel"] <= e["worst_rel_bound"]
    assert e["fused_steps_launches"] == 0          # the plain step on a CPU
    assert smoke_doc["schema"] == "repro_torch.grid_bench/v1"
    assert smoke_doc["host"]["device"] == "cpu"
    assert set(smoke_doc["summary"]) == {"smoke"}


def _het_doc():
    entry = {
        "name": "het:lsm", "engine": "lsm", "n_ssd": 1, "n_latencies": 64,
        "n_threads": 8, "cells": 512, "n_ops": 2000, "loop_s": 10.0,
        "loop_mode": "pipeline", "torch_cold_s": 1.0, "torch_warm_s": 0.5,
        "warm_speedup": 20.0, "worst_rel": 0.01, "worst_rel_bound": 0.0316,
        "loop_reseed_worst_rel": 0.02, "fused_steps_launches": 12, "torch_cohort_warm_s": 0.4,
        "torch_mono_warm_s": 1.2, "mono_speedup": 3.0,
        "cell_steps_bound": 1000, "cell_steps_run": 800,
        "steps_saved_frac": 0.2}
    return {"schema": bench.SCHEMA, "host": {}, "entries": [entry],
            "summary": {"het": {"cells": 512, "loop_s": 10.0,
                                "torch_warm_s": 0.5, "warm_speedup": 20.0,
                                "mono_speedup": 3.0}}}


PLANTED = {
    "schema": (lambda d: d.update(schema="repro.jax_grid_bench/v1"),
               "schema"),
    "no-entries": (lambda d: d.update(entries=[]), "non-empty"),
    "missing-field": (lambda d: d["entries"][0].pop("torch_warm_s"),
                      "missing 'torch_warm_s'"),
    "jax-field-name": (lambda d: d["entries"][0].update(
        jax_warm_s=d["entries"][0].pop("torch_warm_s")), "torch_warm_s"),
    "bool-count": (lambda d: d["entries"][0].update(
        fused_steps_launches=True), "fused_steps_launches"),
    "cells": (lambda d: d["entries"][0].update(cells=511),
              "cells != lats"),
    "zero-time": (lambda d: d["entries"][0].update(torch_cold_s=0.0),
                  "torch_cold_s must be > 0"),
    "worst-rel": (lambda d: d["entries"][0].update(worst_rel=-0.01),
                  "worst_rel must be >= 0"),
    "het-steps": (lambda d: d["entries"][0].update(cell_steps_run=1001),
                  "cell_steps_run exceeds"),
    "het-field": (lambda d: d["entries"][0].pop("mono_speedup"),
                  "missing 'mono_speedup'"),
    "het-summary": (lambda d: d["summary"]["het"].pop("mono_speedup"),
                    "het summary"),
}


def test_validate_accepts_the_planted_documents_base():
    assert bench.validate(_het_doc())


@pytest.mark.parametrize("plant", sorted(PLANTED))
def test_validate_rejects_a_planted_fault(plant):
    doc = copy.deepcopy(_het_doc())
    mutate, msg = PLANTED[plant]
    mutate(doc)
    with pytest.raises(ValueError, match=msg):
        bench.validate(doc)


def test_over_bound_lists_entries_past_grid_tol():
    doc = _het_doc()
    assert bench.over_bound(doc) == []
    doc["entries"][0]["worst_rel"] = 0.04
    assert bench.over_bound(doc) == [
        {"name": "het:lsm", "worst_rel": 0.04, "worst_rel_bound": 0.0316,
         "loop_reseed_worst_rel": 0.02}]
    assert bench.validate(doc)                     # reported, not invalid


def test_floors_are_reported_not_enforced():
    doc = _het_doc()
    doc["summary"].update(
        default={"warm_speedup": 0.5}, mega={"warm_speedup": 6.0,
                                             "cells": 4096})
    doc["summary"]["het"]["mono_speedup"] = 1.2
    got = {f["suite"]: f["met"] for f in bench.floors(doc)}
    assert got == {"default": False, "mega": True, "het": False}
    assert bench.validate(doc)                     # a miss is not a fault
