"""The port's sharded fleet (``repro_torch.core.cluster``) against the
reference's (``repro.core.cluster``).

Contracts, strongest first:

  1. The spec, the partitioners and the plan are the same pure numpy code:
     ``ClusterSpec``, ``shard_of``, ``replica_set``, ``assign_ops``,
     ``_apportion`` and ``build_plan`` give identical results on the same
     inputs (hash and range partitions, replication with ``primary`` and
     ``spread``, ``migrate``, node overrides, routed arrivals with a
     deadline).
  2. The loop backends (``"loop"``, ``"generic"``) are byte-identical to
     the reference's, for the 4-node ``FLEET`` and both example cluster
     scenarios.
  3. Degeneracy: the trivial 1-node spec on the torch grid is bit-identical
     to the plain torch sweep (``trivial-cluster``).
  4. Fed the reference's own draws (``ReferenceDraws``, the reference
     compiled without FMA contraction), every node's torch grid -- and so
     the fleet -- is bit-equal to the reference's jax node grid.
  5. On its own streams the torch fleet sits within ``cluster-torch-vs-loop``
     of the loop fleet and of the reference's jax fleet; shares are
     identical.  The input of ``tests/test_cluster.py``'s fleet test, where
     the reference's jax fleet misses its p99 bound (ROADMAP C11), is held
     here for the torch fleet with the bound unchanged.
  6. Cluster artifacts round-trip through JSON; the torch cluster bench's
     smoke output passes ``tools/check_bench.py``.

Every grid here runs the plain PyTorch step on the CPU (``device="cpu"``).
"""
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro.core import cluster as ref_cl
from repro.core import experiment as ref_ex
from repro.core.engines import run_trace as ref_run_trace
from repro.core.sim import SimConfig as RefSimConfig
from repro.core.sim import replay_jax
from repro.core.sim.arrivals import ArrivalSpec as RefArrivalSpec
from repro_torch.core import cluster as cl
from repro_torch.core import experiment as ex
from repro_torch.core.conformance import CONTRACTS
from repro_torch.core.engines import run_trace
from repro_torch.core.sim import SimConfig
from repro_torch.core.sim import replay_torch as rt
from repro_torch.core.sim.arrivals import ArrivalSpec

from _torch_port_support import (US, ReferenceDraws, bits_equal,
                                 run_grid_no_fma)

ROOT = Path(__file__).resolve().parents[1]

FLEET = {"n_nodes": 4, "partition": "hash", "L_route_us": 5.0,
         "replication": 2, "replica_policy": "spread"}

SPECS = {
    "trivial": {},
    "fleet": FLEET,
    "range-3-primary": dict(n_nodes=3, partition="range", replication=2),
    "range-5-migrate": dict(n_nodes=5, partition="range",
                            migrate={"shard": 1, "to": 3, "at_frac": 0.4}),
    "hash-4-everything": dict(
        n_nodes=4, L_route_us=5.0, replication=3, replica_policy="spread",
        node_overrides={"1": {"io_degrade": 4.0, "T_degrade_us": 400.0,
                              "n_ssd": 2, "L_io_us": 90.0},
                        "3": {"R_io": 150e3, "B_io": 4e8}},
        migrate={"shard": 0, "to": 2, "at_frac": 0.5}),
}


@pytest.fixture
def exit_every_chunk(monkeypatch):
    """Test the early exit after every chunk (results are bit-identical),
    so small cells stop after a chunk or two."""
    monkeypatch.setattr(rt, "_EXIT_CHECK_CHUNKS", 1)


def _scenario_doc(**over):
    doc = dict(engine="hash-index", workload="zipf",
               workload_kwargs={"exponent": 0.9, "read_write": (2, 1),
                                "seed": 3},
               n_keys=1_500, n_wl_ops=800, n_ops=250, latencies_us=(2.0,),
               thread_candidates=(8,))
    doc.update(over)
    return doc


def _both(doc):
    return ex.Scenario(**doc), ref_ex.Scenario(**doc)


def _plan_inputs(sc, pkg):
    """(trace, keys, is_write) of a scenario in package ``pkg`` (``ex`` or
    ``ref_ex``): the post-warmup workload slice aligned with the trace ops,
    as ``Experiment.run`` builds them."""
    store, wl = pkg.Experiment(sc).build()
    run = run_trace if pkg is ex else ref_run_trace
    tr = run(store, wl, warmup_frac=sc.warmup_frac)
    n_warm = int(len(wl) * sc.warmup_frac)
    return tr.trace, wl.keys[n_warm:], wl.is_write[n_warm:]


# -- 1. spec, partitioners, plan -----------------------------------------------


@pytest.mark.parametrize("name", sorted(SPECS))
def test_spec_and_partitioners_equal_the_references(name):
    spec, ref = cl.ClusterSpec(**SPECS[name]), ref_cl.ClusterSpec(**SPECS[name])
    assert spec.to_dict() == ref.to_dict() and spec.key() == ref.key()
    assert spec.is_trivial == ref.is_trivial and spec.L_route == ref.L_route
    assert cl.ClusterSpec.from_dict(spec.to_dict()) == spec
    rng = np.random.default_rng(len(name))
    n_keys = 977
    keys = rng.integers(0, n_keys, 2_000)
    is_write = rng.random(2_000) < 0.3
    assert bits_equal(cl.shard_of(keys, spec, n_keys),
                      ref_cl.shard_of(keys, ref, n_keys))
    got = cl.assign_ops(keys, is_write, spec, n_keys)
    assert got.dtype == np.int64
    assert bits_equal(got, ref_cl.assign_ops(keys, is_write, ref, n_keys))
    for shard in range(spec.n_nodes):
        assert cl.replica_set(shard, spec) == ref_cl.replica_set(shard, ref)
    cfg, rcfg = SimConfig(P=8, seed=7), RefSimConfig(P=8, seed=7)
    for node in range(spec.n_nodes):
        assert dataclasses.asdict(spec.node_config(cfg, node)) == \
            dataclasses.asdict(ref.node_config(rcfg, node))
    assert spec.node_config(cfg, 0) is cfg or "0" in spec.node_overrides
    with pytest.raises(ValueError):
        cl.assign_ops(keys, is_write, spec, 10)


def test_apportion_equals_the_references():
    rng = np.random.default_rng(5)
    for _ in range(50):
        w = rng.integers(0, 9, rng.integers(1, 8)).astype(np.float64)
        w[rng.integers(len(w))] += 1.0
        total = int(rng.integers(0, 5_000))
        got = cl._apportion(total, w)
        assert bits_equal(got, ref_cl._apportion(total, w))
        assert got.sum() == total
    with pytest.raises(ValueError):
        cl._apportion(10, np.zeros(3))


ARRIVALS = {
    "closed": None,
    "poisson-deadline": dict(kind="poisson", rate=200e3, seed=4,
                             deadline=0.002),
    "bursty": dict(kind="bursty", rate=150e3, seed=2, on_fraction=0.25,
                   period=0.005),
}


@pytest.mark.parametrize("arrival", sorted(ARRIVALS))
@pytest.mark.parametrize("name", sorted(SPECS))
def test_build_plan_equals_the_references(name, arrival):
    sc, rsc = _both(_scenario_doc())
    trace, keys, is_write = _plan_inputs(sc, ex)
    rtrace, rkeys, ris_write = _plan_inputs(rsc, ref_ex)
    assert bits_equal(keys, rkeys) and bits_equal(trace.bounds, rtrace.bounds)
    spec, ref = cl.ClusterSpec(**SPECS[name]), ref_cl.ClusterSpec(**SPECS[name])
    a = ARRIVALS[arrival]
    kw = dict(n_ops=300, warmup_ops=None, thread_candidates=(4, 12))
    plan = cl.build_plan(sc.sim_config(), trace, keys, is_write, spec,
                         arrival=ArrivalSpec.from_dict(a) if a else None,
                         **kw)
    want = ref_cl.build_plan(rsc.sim_config(), rtrace, rkeys, ris_write, ref,
                             arrival=RefArrivalSpec.from_dict(a) if a else None,
                             **kw)
    assert bits_equal(plan.assignment, want.assignment)
    assert plan.node_ops == want.node_ops and sum(plan.node_ops) == 300
    assert plan.node_shares == want.node_shares
    assert plan.node_deadline == want.node_deadline
    assert plan.active == want.active
    for k in range(spec.n_nodes):
        assert dataclasses.asdict(plan.node_cfgs[k]) == \
            dataclasses.asdict(want.node_cfgs[k])
        got_t, want_t = plan.node_traces[k], want.node_traces[k]
        assert (got_t is None) == (want_t is None)
        if got_t is not None:
            for col in ("kinds", "durs", "bounds"):
                assert bits_equal(getattr(got_t, col), getattr(want_t, col))
        got_a, want_a = plan.node_arrivals[k], want.node_arrivals[k]
        assert (got_a is None) == (want_a is None)
        if got_a is not None:
            assert got_a.tobytes() == want_a.tobytes()
    if spec.is_trivial:
        # the identity rule the degeneracy contract rests on
        assert plan.node_traces[0] is trace


# -- 2. the loop backends, byte for byte ---------------------------------------


def _point_dict(pt):
    d = dataclasses.asdict(pt)
    return json.dumps(d, sort_keys=True, default=repr)


@pytest.mark.parametrize("backend", ["loop", "generic"])
def test_fleet_loop_backends_byte_identical_to_reference(backend):
    sc, rsc = _both(_scenario_doc(n_wl_ops=900))
    trace, keys, is_write = _plan_inputs(sc, ex)
    rtrace, rkeys, ris_write = _plan_inputs(rsc, ref_ex)
    arr = dict(kind="poisson", rate=250e3, seed=5, deadline=0.0015)
    kw = dict(n_ops=300, backend=backend, collect_latency=True,
              collect_percentiles=True, arrival=arr)
    got = cl.sweep_cluster(sc.sim_config(), trace, keys, is_write,
                           cl.ClusterSpec(**FLEET), [1 * US, 4 * US], (4, 8),
                           **kw)
    want = ref_cl.sweep_cluster(rsc.sim_config(), rtrace, rkeys, ris_write,
                                ref_cl.ClusterSpec(**FLEET), [1 * US, 4 * US],
                                (4, 8), **kw)
    assert [_point_dict(p) for p in got] == [_point_dict(p) for p in want]
    assert sum(nc.n_ops for nc in got[0].nodes) == 300


@pytest.mark.parametrize("backend", ["loop", "generic"])
@pytest.mark.parametrize("name", ["cluster_hot_shard", "cluster_degraded_node"])
def test_example_cluster_scenarios_loop_rows_identical(name, backend):
    text = (ROOT / "examples" / "scenarios" / f"{name}.json").read_text()
    got = ex.Experiment(ex.Scenario.from_json(text), ex.RunOptions(
        backend=backend, collect_percentiles=True)).run()
    want = ref_ex.Experiment(ref_ex.Scenario.from_json(text), ref_ex.RunOptions(
        backend=backend, collect_percentiles=True)).run()
    assert got.to_dict() == want.to_dict()
    assert all(len(r.nodes) == got.scenario.cluster["n_nodes"]
               for r in got.rows)


def test_cluster_backend_validation():
    sc, _ = _both(_scenario_doc())
    trace, keys, is_write = _plan_inputs(sc, ex)
    spec = cl.ClusterSpec(**FLEET)
    assert cl.CLUSTER_BACKENDS == ("loop", "generic", "torch")
    with pytest.raises(ValueError, match="backend"):
        cl.sweep_cluster(sc.sim_config(), trace, keys, is_write, spec,
                         [1 * US], (8,), backend="jax")
    with pytest.raises(ValueError, match="loop"):
        cl.sweep_cluster(sc.sim_config(), trace, keys, is_write, spec,
                         [1 * US], (8,), collect_latency=True, device="cpu")
    assert cl.sweep_cluster(sc.sim_config(), trace, keys, is_write, spec,
                            [], (8,), device="cpu") == []
    with pytest.raises(ValueError, match="unknown ClusterSpec field"):
        ex.Scenario(**_scenario_doc(cluster={"n_nodes": 2, "quorum": 1}))


# -- 3. degeneracy on the torch grid -------------------------------------------


@pytest.mark.parametrize("engine", ["hash-index", "lsm", "slab-cache"])
def test_trivial_spec_bit_identical_to_plain_torch_sweep(exit_every_chunk,
                                                         engine):
    doc = _scenario_doc(engine=engine, workload_kwargs={
        "exponent": 0.9, "read_write": (1, 0), "seed": 3}, n_ops=150,
        arrival={"kind": "poisson", "rate": 120e3, "seed": 5})
    opts = ex.RunOptions(device="cpu", collect_percentiles=True)
    plain = ex.Experiment(ex.Scenario(**doc), opts).run()
    triv = ex.Experiment(ex.Scenario(**doc, cluster={"n_nodes": 1}),
                         opts).run()
    for ra, rb in zip(plain.rows, triv.rows):
        assert ra.throughput == rb.throughput
        assert ra.n_threads == rb.n_threads
        assert ra.per_thread == rb.per_thread
        assert ra.tail == rb.tail
        assert rb.nodes is not None and len(rb.nodes) == 1


# -- 4. node grids bit-equal under the reference's draws -----------------------


INJECTED = {
    "fleet-poisson-deadline": _scenario_doc(
        n_ops=200, latencies_us=(1.0, 5.0), thread_candidates=(6, 8),
        cluster=FLEET, arrival={"kind": "poisson", "rate": 250e3, "seed": 11,
                                "deadline": 0.0015}),
    "corpus-seed-26": json.loads(
        (ROOT / "examples" / "conformance" / "seed_26.json").read_text()),
}


@pytest.mark.parametrize("name", sorted(INJECTED))
def test_node_grids_bit_equal_to_reference_under_injected_draws(
        monkeypatch, exit_every_chunk, name):
    doc = INJECTED[name]
    port_grids, ref_grids = [], []
    real_port, real_ref = rt.sweep_grid, replay_jax.sweep_grid

    def port_grid(cfg, trace, *a, **kw):
        g = real_port(cfg, trace, *a, draws=ReferenceDraws(cfg.seed), **kw)
        port_grids.append(g)
        return g

    def ref_grid(*a, **kw):
        g = real_ref(*a, **kw)
        ref_grids.append(g)
        return g

    monkeypatch.setattr(rt, "sweep_grid", port_grid)
    monkeypatch.setattr(replay_jax, "sweep_grid", ref_grid)
    monkeypatch.setattr(replay_jax, "_run_grid", run_grid_no_fma)
    got = ex.Experiment(ex.Scenario.from_dict(doc), ex.RunOptions(
        device="cpu", collect_percentiles=True)).run()
    want = ref_ex.Experiment(ref_ex.Scenario.from_dict(doc), ref_ex.RunOptions(
        backend="jax", collect_percentiles=True)).run()
    n_active = sum(1 for nd in want.rows[0].nodes if nd["n_ops"])
    assert len(port_grids) == len(ref_grids) == n_active > 1
    for g, r in zip(port_grids, ref_grids):
        for fld in ("throughput", "time", "mem_stall_total", "mem_accesses",
                    "lat_max", "missed", "lat_count"):
            assert bits_equal(getattr(g, fld), getattr(r, fld)), fld
        # histogram planes: equal, or unit mass moved to an adjacent bin
        d = (g.lat_hist - r.lat_hist).reshape(-1, g.lat_hist.shape[-1])
        assert np.abs(d).sum() <= 2 * d.shape[0]
    for a, b in zip(got.rows, want.rows):
        assert a.per_thread == b.per_thread and a.n_threads == b.n_threads
        assert [n["throughput"] for n in a.nodes] == \
            [n["throughput"] for n in b.nodes]
        for q in ("p50_us", "p90_us", "p99_us"):
            assert a.tail[q] == pytest.approx(b.tail[q], rel=0.04), q


# -- 5. tolerance contracts on the port's own streams --------------------------


@pytest.fixture(scope="module")
def hot_shard():
    text = (ROOT / "examples" / "scenarios" / "cluster_hot_shard.json"
            ).read_text()
    grid = ex.Experiment(ex.Scenario.from_json(text), ex.RunOptions(
        device="cpu", collect_percentiles=True)).run()
    loop = ex.Experiment(ex.Scenario.from_json(text), ex.RunOptions(
        backend="loop", collect_percentiles=True)).run()
    jx = ref_ex.Experiment(ref_ex.Scenario.from_json(text), ref_ex.RunOptions(
        backend="jax", collect_percentiles=True)).run()
    return grid, loop, jx


def _within_fleet_contract(a, b):
    """Rows ``a`` (the reference side) and ``b`` under
    ``cluster-torch-vs-loop`` at its reference size (800 ops): throughput,
    p50 and p99; shares identical."""
    c = CONTRACTS["cluster-torch-vs-loop"]
    assert a.n_threads == b.n_threads
    assert abs(a.throughput - b.throughput) / a.throughput <= \
        c.throughput_tol
    assert [n["share"] for n in a.nodes] == [n["share"] for n in b.nodes]
    for f, tol in (("p50_us", c.p50_tol), ("p99_us", c.p99_tol)):
        rel = abs(a.tail[f] - b.tail[f]) / max(a.tail[f], b.tail[f])
        assert rel <= tol, (f, a.tail, b.tail)


@pytest.mark.parametrize("against", ["loop", "jax"])
def test_torch_fleet_within_the_fleet_contract(hot_shard, against):
    grid, loop, jx = hot_shard
    assert grid.scenario.n_ops == CONTRACTS["cluster-torch-vs-loop"].ref_ops
    for a, b in zip(loop.rows if against == "loop" else jx.rows, grid.rows):
        _within_fleet_contract(a, b)
        assert b.tail["source"] == "hist"
        assert b.throughput == pytest.approx(
            sum(n["throughput"] for n in b.nodes), rel=1e-12)


def test_torch_fleet_at_the_reference_fleet_tests_input(exit_every_chunk):
    """``tests/test_cluster.py``'s fleet input (hash-index, zipf 1.2, the
    4-node ``FLEET``, Poisson 300 k/s, 800 ops, 2 us, 8 threads), where the
    reference's jax fleet misses the p99 bound (ROADMAP C11: 0.139 against
    0.10).  The torch fleet is held to the same, unchanged bounds."""
    doc = _scenario_doc(workload_kwargs={"exponent": 1.2,
                                         "read_write": (1, 0), "seed": 3},
                        n_wl_ops=1_600, n_ops=800, cluster=FLEET,
                        arrival={"kind": "poisson", "rate": 300e3,
                                 "seed": 11})
    sc = ex.Scenario(**doc)
    loop = ex.Experiment(sc, ex.RunOptions(backend="loop",
                                           collect_percentiles=True)).run()
    grid = ex.Experiment(sc, ex.RunOptions(device="cpu",
                                           collect_percentiles=True)).run()
    for a, b in zip(loop.rows, grid.rows):
        _within_fleet_contract(a, b)


# -- 6. artifacts and the bench ------------------------------------------------


def test_cluster_artifacts_round_trip(hot_shard):
    grid, loop, _ = hot_shard
    for art in (grid, loop):
        assert ex.RunArtifact.from_json(art.to_json()) == art
        # either package reads the other's cluster artifact
        assert ref_ex.RunArtifact.from_json(art.to_json()).to_dict() == \
            art.to_dict()
        assert all(r.nodes and len(r.nodes) == 4 for r in art.rows)


def test_cluster_bench_smoke_passes_check_bench(tmp_path, monkeypatch):
    from benchmarks import cluster_bench_torch as cb

    monkeypatch.setattr(rt, "_EXIT_CHECK_CHUNKS", 1)
    out = tmp_path / "cluster.json"
    cb.main(["--smoke", "--device", "cpu", "--scenario", "degraded_node",
             "--out", str(out)])
    doc = json.loads(out.read_text())
    assert doc["schema"] == cb.SCHEMA and doc["backend"] == "torch"
    assert doc["host"]["device"] == "cpu"
    assert {e["source"] for e in doc["entries"]} == {"hist"}
    res = subprocess.run([sys.executable, str(ROOT / "tools" / "check_bench.py"),
                          str(out)], capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "fleet invariants ok" in res.stdout
