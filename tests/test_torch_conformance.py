"""``repro_torch.core.conformance`` -- the port's contract table and
differential fuzzer -- against the reference's ``repro.core.conformance``.

Layers, cheapest first:

1. The contract table: internally consistent (as the reference's is), its
   tolerance pairs carrying the reference's numbers, and the ``1/sqrt(n)``
   law the reference's ``jax_grid_tol`` / ``tail_tol``.
2. Sampling, shrinking and repro emission: ``scenario_for_seed`` gives the
   reference's scenarios seed for seed; the shrinker minimizes a planted
   failure (a stubbed ``check_scenario``, no simulation).
3. The checks on the host: the ``kernel`` check raises off the card; the
   corpus under ``examples/conformance/`` replays through ``compiled`` and
   ``torch`` on ``device="cpu"`` with exactly the failures on record
   (``_torch_kernel_cases.CORPUS_KNOWN_MISSES``); the CLI.
"""
import dataclasses
import json
import os
import random
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro.core import conformance as ref_conf
from repro_torch.core import conformance
from repro_torch.core.conformance import (
    CHECK_NAMES,
    CONTRACTS,
    ConformanceFailure,
    grid_tol,
    replay_corpus,
    sample_scenario,
    scenario_for_seed,
    shrink_scenario,
    tail_tol,
    write_repro,
)
from repro_torch.core.experiment import Scenario
from repro_torch.core.sim import replay_torch as rt

import _torch_kernel_cases as cases

ROOT = Path(__file__).resolve().parent.parent
CORPUS = ROOT / "examples" / "conformance"
HOST = ("compiled", "torch")

#: The port's contract names and the reference's counterpart of each.
COUNTERPART = {
    "generic-vs-compiled": "generic-vs-compiled",
    "torch-kernel-vs-plain": "pallas-vs-jnp",
    "trivial-cluster": "trivial-cluster",
    "torch-vs-loop": "jax-vs-loop",
    "cluster-torch-vs-loop": "cluster-jax-vs-loop",
}


@pytest.fixture
def exit_every_chunk(monkeypatch):
    monkeypatch.setattr(rt, "_EXIT_CHECK_CHUNKS", 1)


# -- 1. contract table + tolerance law -----------------------------------------


class TestContractTable:
    def test_keys_match_contract_names(self):
        for key, c in CONTRACTS.items():
            assert key == c.name
        assert sorted(CONTRACTS) == sorted(COUNTERPART)

    def test_bit_identical_contracts_carry_no_tolerances(self):
        for c in CONTRACTS.values():
            if c.bit_identical:
                assert c.throughput_tol is None
                assert c.p50_tol is None and c.p99_tol is None

    def test_tolerance_contracts_fully_specified(self):
        for c in CONTRACTS.values():
            if not c.bit_identical:
                assert c.throughput_tol and c.ref_ops
                assert c.p50_tol and c.p99_tol and c.tail_ref_ops
                assert c.p50_tol <= c.p99_tol

    def test_every_contract_documents_why(self):
        assert all(c.why for c in CONTRACTS.values())

    def test_all_backend_pairs_covered(self):
        flat = " ".join(part for c in CONTRACTS.values() for part in c.pair)
        for backend in ("simulate", "simulate_compiled", "sweep_grid",
                        "use_kernel=True", "use_kernel=False",
                        "sweep_cluster"):
            assert backend in flat

    @pytest.mark.parametrize("name", sorted(COUNTERPART))
    def test_numbers_are_the_references(self, name):
        got, want = CONTRACTS[name], ref_conf.CONTRACTS[COUNTERPART[name]]
        for fld in ("bit_identical", "throughput_tol", "ref_ops", "p50_tol",
                    "p99_tol", "tail_ref_ops"):
            assert getattr(got, fld) == getattr(want, fld), fld

    def test_gates_and_slacks_are_the_references(self):
        for name in ("P50_TOL", "P99_TOL", "P50_BIMODAL_GATE", "TAIL_REF_OPS",
                     "CLUSTER_TAIL_TOL", "CLUSTER_REF_OPS", "FUZZ_SLACK",
                     "FUZZ_TAIL_SLACK", "FUZZ_CLUSTER_SLACK",
                     "TAIL_QUEUE_GATE", "PEAKY_TAIL_MIN_OPS",
                     "DIURNAL_PEAKY_AMPLITUDE"):
            assert getattr(conformance, name) == getattr(ref_conf, name)
        assert conformance.GRID_TOL == ref_conf.JAX_GRID_TOL
        assert conformance.GRID_REF_OPS == ref_conf.JAX_GRID_REF_OPS
        assert conformance.CLUSTER_TOL == ref_conf.CLUSTER_JAX_TOL
        assert conformance.KERNEL_CLIP_OPS == ref_conf.PALLAS_CLIP_OPS

    @pytest.mark.parametrize("n_ops", [1, 100, 400, 800, 5_000, 20_000,
                                       80_000])
    def test_tolerance_law_is_the_references(self, n_ops):
        for slack in (1.0, 1.25, 4.0):
            assert grid_tol(n_ops, slack=slack) == \
                ref_conf.jax_grid_tol(n_ops, slack=slack)
            assert grid_tol(n_ops, base=0.01, ref_ops=800, slack=slack) == \
                ref_conf.jax_grid_tol(n_ops, base=0.01, ref_ops=800,
                                      slack=slack)
            for base in (0.08, 0.12):
                assert tail_tol(n_ops, base=base, slack=slack) == \
                    ref_conf.tail_tol(n_ops, base=base, slack=slack)

    def test_literals_map_onto_the_law(self):
        assert grid_tol(5_000) == pytest.approx(0.02)
        assert grid_tol(20_000) == pytest.approx(0.01)
        assert grid_tol(5_000, slack=1.25) == pytest.approx(0.025)
        assert tail_tol(100, base=0.12) == pytest.approx(
            2 * tail_tol(400, base=0.12))


# -- 2. sampling, shrinking, repros --------------------------------------------


@pytest.mark.parametrize("seed", range(25))
def test_scenario_for_seed_is_the_references(seed):
    got = scenario_for_seed(seed)
    assert got.to_dict() == ref_conf.scenario_for_seed(seed).to_dict()
    assert Scenario.from_json(got.to_json()) == got


def test_sample_scenario_consumes_the_references_stream():
    a, b = random.Random(1), random.Random(1)
    for _ in range(5):
        assert sample_scenario(a, 3).to_dict() == \
            ref_conf.sample_scenario(b, 3).to_dict()


class TestShrinker:
    @staticmethod
    def _fails_if(pred):
        def stub(sc, checks=CHECK_NAMES, device="cuda"):
            if pred(sc):
                return [ConformanceFailure("torch", "stub", "fail", sc)]
            return []
        return stub

    def test_shrinks_to_minimal_failing_spec(self, monkeypatch):
        monkeypatch.setattr(conformance, "check_scenario",
                            self._fails_if(lambda sc: sc.n_ops >= 300))
        sc = scenario_for_seed(2)
        assert sc.n_ops >= 300
        small, evals = shrink_scenario(sc, device="cpu")
        assert small.n_ops == 300
        assert 0 < evals <= 40
        assert small.name.endswith("-shrunk")
        assert not small.cluster and not small.arrival
        assert len(small.latencies_us) == 1
        assert len(small.thread_candidates) == 1

    def test_shrinker_walks_the_references_path(self, monkeypatch):
        # the same planted failure shrinks to the same spec in both packages
        for mod in (conformance, ref_conf):
            monkeypatch.setattr(mod, "check_scenario", self._fails_if(
                lambda sc: bool(sc.cluster) and sc.n_ops >= 120))
        for seed in range(40):
            if scenario_for_seed(seed).cluster:
                break
        got, n = shrink_scenario(scenario_for_seed(seed), device="cpu")
        want, m = ref_conf.shrink_scenario(ref_conf.scenario_for_seed(seed))
        assert got.to_dict() == want.to_dict() and n == m
        assert got.cluster and got.n_ops < scenario_for_seed(seed).n_ops

    def test_budget_bounds_evaluations(self, monkeypatch):
        monkeypatch.setattr(conformance, "check_scenario",
                            self._fails_if(lambda sc: True))
        _, evals = shrink_scenario(scenario_for_seed(2), budget=5,
                                   device="cpu")
        assert evals <= 5

    def test_fuzz_shrinks_and_writes_repros(self, monkeypatch, tmp_path):
        monkeypatch.setattr(conformance, "check_scenario",
                            self._fails_if(lambda sc: sc.n_ops >= 300))
        fails = conformance.fuzz(4, 0, HOST, failures_dir=tmp_path,
                                 device="cpu")
        failing = [s for s in range(4) if scenario_for_seed(s).n_ops >= 300]
        assert len(fails) == len(failing) > 0
        written = sorted(tmp_path.glob("repro_torch_*.json"))
        assert len(written) == len(failing)
        for path in written:
            assert Scenario.from_json(path.read_text()).n_ops in (300, 400)


class TestReproEmission:
    def test_write_repro_round_trips(self, tmp_path):
        sc = scenario_for_seed(3)
        path = write_repro(sc, "torch", tmp_path)
        assert path.name == f"repro_torch_{sc.name}.json"
        assert Scenario.from_json(path.read_text()) == sc

    def test_replay_corpus_empty_dir_raises(self, tmp_path):
        with pytest.raises(FileNotFoundError):
            replay_corpus(tmp_path, HOST, device="cpu")

    def test_replay_corpus_runs_every_file(self, tmp_path, monkeypatch):
        seen = []
        monkeypatch.setattr(
            conformance, "check_scenario",
            lambda sc, checks=CHECK_NAMES, device="cuda":
                seen.append((sc.name, device)) or [])
        for seed in (1, 2):
            write_repro(scenario_for_seed(seed), "torch", tmp_path)
        assert replay_corpus(tmp_path, HOST, device="cpu") == []
        assert sorted(seen) == [("fuzz-1", "cpu"), ("fuzz-2", "cpu")]


# -- 3. the checks on the host -------------------------------------------------


def _cheapest():
    scs = [Scenario.from_json(p.read_text())
           for p in sorted(CORPUS.glob("*.json"))]
    return min((s for s in scs if not s.cluster),
               key=lambda s: s.n_ops * s.n_wl_ops)


def test_kernel_check_raises_off_the_card():
    sc = _cheapest()
    with pytest.raises(ValueError, match="kernel"):
        conformance.check_scenario(sc, device="cpu")
    with pytest.raises(ValueError, match="kernel"):
        conformance.check_scenario(sc, ("kernel",), device="cpu")
    with pytest.raises(ValueError, match="kernel"):
        conformance._check_kernel(sc, torch.device("cpu"))
    with pytest.raises(ValueError, match="unknown check"):
        conformance.check_scenario(sc, ("jax",), device="cpu")
    assert CHECK_NAMES == ("compiled", "torch", "kernel")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            conformance.check_scenario(sc, HOST)


def test_cheapest_corpus_entry_replays_green(exit_every_chunk):
    sc = _cheapest()
    fails = conformance.check_scenario(sc, HOST, device="cpu")
    assert not fails, [str(f) for f in fails]


def test_full_corpus_replays_with_exactly_the_misses_on_record(
        exit_every_chunk):
    fails = replay_corpus(CORPUS, HOST, device="cpu")
    new, gone = cases.unexpected_failures(fails)
    assert not new, [str(f) for f in new]
    assert not gone, f"recorded misses that did not recur: {gone}"


def test_seed_26_misses_follow_the_stream(exit_every_chunk):
    """The corpus's one recorded miss (ROADMAP C14) is sampling noise of
    the stream, not a fault of either backend: with the scenario's seed set
    to 9, the reference's own check misses the same fleet p99 bound on its
    jax fleet, and the port's check meets it on the torch fleet."""
    from repro.core.experiment import Scenario as RefScenario

    text = (CORPUS / "seed_26.json").read_text()
    sc = Scenario.from_json(text)
    ref_sc = RefScenario.from_json(text)
    assert ((sc.name, "torch", "cluster-torch-vs-loop")
            in {k[:3] for k in cases.CORPUS_KNOWN_MISSES})
    got = conformance.check_scenario(dataclasses.replace(sc, seed=9), HOST,
                                     device="cpu")
    assert not got, [str(f) for f in got]
    want = ref_conf.check_scenario(dataclasses.replace(ref_sc, seed=9),
                                   ("compiled", "jax"))
    assert [(f.check, f.contract, f.message.split(":")[0]) for f in want] \
        == [("jax", "cluster-jax-vs-loop", "row 0 (L5us) p99_us")]


def _cli(module, *args, timeout=120):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-m", module, *args],
                          capture_output=True, text=True, env=env,
                          timeout=timeout, cwd=str(ROOT))


@pytest.mark.parametrize("seed", [0, 17])
def test_cli_sample_prints_the_references_scenario(seed):
    got = _cli("repro_torch.core.conformance", "sample", str(seed))
    want = _cli("repro.core.conformance", "sample", str(seed))
    assert got.returncode == want.returncode == 0, got.stderr + want.stderr
    assert got.stdout == want.stdout
    assert json.loads(got.stdout)["name"] == f"fuzz-{seed}"


def test_cli_replay_on_the_host(tmp_path):
    sc = _cheapest()
    (tmp_path / "one.json").write_text(sc.to_json())
    out = _cli("repro_torch.core.conformance", "replay", str(tmp_path),
               "--device", "cpu", "--checks", "compiled,torch", timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "0 conformance failure(s)" in out.stdout
    bad = _cli("repro_torch.core.conformance", "replay", str(tmp_path),
               "--device", "cpu")
    assert bad.returncode != 0 and "kernel" in bad.stderr
