"""The port's grid replay (``repro_torch.core.sim.replay_torch``) against the
reference's (``repro.core.sim.replay_jax``).

Contracts, strongest first:

  1. trace lowering round-trips exactly, and a trace lowered by either
     package is carried across to the other losslessly;
  2. the pure-numpy planners give the same layouts as the reference's;
  3. fed the reference's own init draws and chunk feed, a grid is bit-equal
     to the reference's ``sweep_grid`` (whose grid program is compiled at
     XLA's optimisation level 0 here: at the default level XLA-CPU contracts
     ``a*b+c`` into fused multiply-adds, eager PyTorch never does);
  4. the counter-based generator draws the documented bits, and a cell's
     numbers never depend on grid composition, cohorts or the early exit;
  5. every ``ValueError`` of ``sweep_grid``.

Tolerance equivalence against the host loop on the port's own streams is in
``test_torch_replay_tolerance.py``.
"""
import dataclasses
from functools import partial

import numpy as np
import pytest
import torch

from repro.core.sim import SimConfig as RefSimConfig
from repro.core.sim import replay_jax
from repro.core.sim.arrivals import generate_arrivals as ref_generate_arrivals
from repro.core.sim.arrivals import ArrivalSpec as RefArrivalSpec
from repro.core.trace_ir import CompiledTrace as RefCompiledTrace
from repro_torch.core.conformance import grid_tol
from repro_torch.core.sim import SimConfig
from repro_torch.core.sim import replay_torch as rt
from repro_torch.core.trace_ir import CompiledTrace

from _torch_port_support import (ENGINES, US, ReferenceDraws, engine_trace,
                                 run_grid_no_fma)


@pytest.fixture(scope="module")
def hash_small():
    return engine_trace("hash-index").trace


@pytest.fixture(scope="module")
def hash_small_ref():
    return engine_trace("hash-index", port=False).trace


@pytest.fixture
def exit_every_chunk(monkeypatch):
    """Test the early exit after every chunk, so small cells stop after a
    chunk or two instead of a whole 4096-step bucket."""
    monkeypatch.setattr(rt, "_EXIT_CHECK_CHUNKS", 1)


# -- 1. lowering ---------------------------------------------------------------


@pytest.mark.parametrize("engine", ENGINES)
def test_trace_arrays_round_trip_and_cross_package(engine):
    trace = engine_trace(engine).trace
    ta = rt.lower_trace(trace)
    back = ta.to_trace()
    assert np.array_equal(back.kinds, trace.kinds)
    assert np.array_equal(back.durs, trace.durs)           # float64, exact
    assert np.array_equal(back.bounds, trace.bounds)
    # the reference's lowering of the same columns, carried across
    ref_trace = RefCompiledTrace.from_columns(trace.kinds, trace.durs,
                                              trace.bounds)
    ra = replay_jax.lower_trace(ref_trace)
    carried = rt.TraceArrays.from_columns(
        np.asarray(ra.kinds), np.asarray(ra.durs), np.asarray(ra.op_starts),
        np.asarray(ra.op_ends), ra.n_ops, ra.n_subops)
    for name in ("kinds", "durs", "op_starts", "op_ends"):
        a, b = getattr(ta, name), getattr(carried, name)
        assert a.dtype == b.dtype and torch.equal(a, b), name
    assert (ta.n_ops, ta.n_subops) == (carried.n_ops, carried.n_subops)


def test_state_numpy_round_trip(hash_small):
    co = rt.plan_grid(SimConfig(P=4, n_ssd=2, R_io=250e3), hash_small,
                      [1 * US], [3, 4], n_ops=50, device="cpu",
                      collect_percentiles=True)[0]
    planes = rt.state_to_numpy(co.state)
    again = rt.state_from_numpy(planes)
    assert [p.dtype for p in again] == [p.dtype for p in co.state]
    assert all(torch.equal(a, b) for a, b in zip(again, co.state))
    assert planes[1].dtype == np.int32 and planes[0].dtype == np.float64
    assert all(p.is_contiguous() for p in co.state)


# -- 2. planners ---------------------------------------------------------------


def test_planners_equal_the_references():
    rng = np.random.default_rng(4)
    for _ in range(25):
        n_ops_t = int(rng.integers(3, 60))
        lens = rng.integers(1, 9, n_ops_t)
        bounds = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
        kinds = rng.integers(0, 4, bounds[-1]).astype(np.int8)
        durs = rng.random(bounds[-1]) * 1e-6
        tp = CompiledTrace.from_columns(kinds, durs, bounds)
        tr = RefCompiledTrace.from_columns(kinds, durs, bounds)
        window = int(rng.integers(1, 4 * n_ops_t))
        assert rt._max_window_subops(bounds, window) == \
            replay_jax._max_window_subops(bounds, window)
        n_ops = int(rng.integers(1, 3000))
        warm, thr = int(rng.integers(0, 300)), int(rng.integers(1, 200))
        assert rt._steps_bound(tp, n_ops, warm, thr) == \
            replay_jax._steps_bound(tr, n_ops, warm, thr)
        cands = [int(c) for c in rng.integers(1, 130, rng.integers(1, 7))]
        assert rt._thread_buckets(cands) == replay_jax._thread_buckets(cands)
        for warmup in (None, 5):
            for bucketed in (True, False):
                for n_cores in (1, 2):
                    assert rt._cohorts(tp, cands, n_ops, warmup, n_cores,
                                       bucketed) == \
                        replay_jax._cohorts(tr, cands, n_ops, warmup,
                                            n_cores, bucketed)
    for n, b in ((0, 8), (1, 8), (8, 8), (9, 8), (4097, 4096)):
        assert rt._bucket(n, b) == replay_jax._bucket(n, b)
    for kw in (dict(), dict(eps=0.1, rho=0.5, L_io_jitter=0.0),
               dict(R_io=1e5, B_io=1e8, B_mem=1e9, T_lock=1e-7,
                    io_degrade=2.0)):
        assert rt._make_flags(SimConfig(**kw)) == \
            replay_jax._make_flags(RefSimConfig(**kw))


# -- 3. bit-equality with the reference under its own draws --------------------


def _reference_grid(monkeypatch, cfg_kw, trace, lats, cands, **kw):
    """The reference's ``sweep_grid`` with its grid program compiled at
    optimisation level 0 (no FMA contraction); nothing else is changed."""
    monkeypatch.setattr(replay_jax, "_run_grid", run_grid_no_fma)
    return replay_jax.sweep_grid(RefSimConfig(**cfg_kw), trace, lats, cands,
                                 **kw)


BIT_EQUAL_CONFIGS = {
    "2ssd-clocks-jitter": (dict(P=12, seed=7, n_ssd=2, R_io=250e3,
                                B_io=400e6, L_switch=0.3 * US), {}),
    "2cores-eps-rho-lock-bmem": (dict(P=6, seed=3, n_cores=2, eps=0.05,
                                      rho=0.9, T_lock=0.1 * US,
                                      B_mem=64 / (0.5 * US),
                                      io_degrade=2.0, T_degrade=300 * US),
                                 {}),
    "open-loop-percentiles": (dict(P=12, seed=5, R_io=250e3),
                              dict(collect_percentiles=True,
                                   deadline=400 * US, open_loop=True)),
}


@pytest.mark.parametrize("name", sorted(BIT_EQUAL_CONFIGS))
def test_grid_bit_equal_to_reference_under_injected_draws(
        monkeypatch, exit_every_chunk, hash_small, hash_small_ref, name):
    cfg_kw, extra = BIT_EQUAL_CONFIGS[name]
    extra = dict(extra)
    lats, cands, n_ops = [1 * US, 5 * US], [6, 8], 120
    if extra.pop("open_loop", False):
        arr = ref_generate_arrivals(
            RefArrivalSpec(kind="poisson", rate=30e3, seed=2), 400)
        extra["arrivals"] = arr
    ref = _reference_grid(monkeypatch, cfg_kw, hash_small_ref, lats, cands,
                          n_ops=n_ops, **extra)
    got = rt.sweep_grid(SimConfig(**cfg_kw), hash_small, lats, cands,
                        n_ops=n_ops, device="cpu",
                        draws=ReferenceDraws(cfg_kw["seed"]), **extra)
    for fld in ("throughput", "time", "mem_stall_total", "mem_accesses"):
        assert np.array_equal(getattr(ref, fld), getattr(got, fld)), fld
    assert (ref.ops, ref.steps, ref.cell_steps_bound) == \
        (got.ops, got.steps, got.cell_steps_bound)
    if "collect_percentiles" in extra:
        assert np.array_equal(ref.lat_max, got.lat_max)
        assert np.array_equal(ref.missed, got.missed)
        assert np.array_equal(ref.lat_count, got.lat_count)
        # histogram planes: equal, or unit mass moved to an adjacent bin
        d = (ref.lat_hist - got.lat_hist).reshape(-1, ref.lat_hist.shape[-1])
        assert np.abs(d).sum() <= 2 * d.shape[0]
        for q in ("p50", "p90", "p99"):
            np.testing.assert_allclose(getattr(ref, q), getattr(got, q),
                                       rtol=0.04)
        assert got.result(0, 0).latency_summary.source == "hist"


# -- 4. the generator, purity, cohorts, early exit -----------------------------


def _splitmix_py(z):
    m = (1 << 64) - 1
    z = (z + 0x9E3779B97F4A7C15) & m
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & m
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & m
    return z ^ (z >> 31)


def test_splitmix_draws_match_a_pure_python_model():
    """The integer tensor arithmetic (wrapping multiplies, masked logical
    shifts) reproduces 64-bit splitmix exactly, so the card and the CPU draw
    the same bits; draws lie in [0, 1) and look uniform."""
    seed, ids = 7, np.array([0, 1, 0xFFFFFFFF, 123456789], dtype=np.uint32)
    d = rt.SplitMixDraws(seed)
    u_cursor, u_thread = d.init(ids, 5)
    m = (1 << 64) - 1
    for g, sid in enumerate(ids.tolist()):
        key = _splitmix_py(_splitmix_py(seed & m) ^ sid)
        want = (_splitmix_py(_splitmix_py(key)) >> 11) * 2.0 ** -53
        assert float(u_cursor[g]) == want
        kt = _splitmix_py((_splitmix_py((key + 2) & m) + 3) & m)
        want_t = (_splitmix_py((kt + 1) & m) >> 11) * 2.0 ** -53
        assert float(u_thread[g, 3, 1]) == want_t
    us = d.chunk(ids, 2, 3)
    assert us.shape == (1024, 3, 4) and us.dtype == torch.float64
    kc = _splitmix_py((_splitmix_py(_splitmix_py(seed & m) ^ 1) + 1) & m)
    ctr = (2 * 1024 + 17) * 4 + 2
    want = (_splitmix_py(kc ^ _splitmix_py(ctr)) >> 11) * 2.0 ** -53
    assert float(us[17, 2, 1]) == want
    big = d.chunk(np.arange(64, dtype=np.uint32), 0, 2)
    assert 0.0 <= float(big.min()) and float(big.max()) < 1.0
    assert abs(float(big.mean()) - 0.5) < 0.005
    assert abs(float(big.var()) - 1 / 12) < 0.002
    # init draws of a thread do not depend on the padding to T_max
    assert torch.equal(d.init(ids, 9)[1][:, :5], u_thread)


def test_cell_results_independent_of_grid_composition(exit_every_chunk,
                                                      hash_small):
    cfg = SimConfig(P=12, seed=7)
    alone = rt.sweep_grid(cfg, hash_small, [5 * US], [8], n_ops=150,
                          device="cpu")
    batched = rt.sweep_grid(cfg, hash_small, [0.1 * US, 5 * US], [5, 8],
                            n_ops=150, device="cpu")
    assert alone.throughput[0, 0] == batched.throughput[1, 1]
    assert alone.mem_stall_total[0, 0] == batched.mem_stall_total[1, 1]
    assert alone.mem_accesses[0, 0] == batched.mem_accesses[1, 1]


def test_cohorts_monolithic_and_early_exit_bit_identical(monkeypatch,
                                                         hash_small):
    cfg = SimConfig(P=12, seed=7, n_ssd=2, R_io=250e3, L_switch=0.3 * US)
    lats, cands, n_ops = [0.5 * US, 5 * US], [3, 8], 100
    monkeypatch.setattr(rt, "_EXIT_CHECK_CHUNKS", 1)
    coh = rt.sweep_grid(cfg, hash_small, lats, cands, n_ops=n_ops,
                        device="cpu")
    assert coh.cell_steps_run < coh.cell_steps_bound     # the exit fired
    mono = rt.sweep_grid(cfg, hash_small, lats, cands, n_ops=n_ops,
                         device="cpu", bucket_threads=False)
    monkeypatch.undo()
    full = rt.sweep_grid(cfg, hash_small, lats, [8], n_ops=n_ops,
                         device="cpu", early_exit=False)
    assert full.cell_steps_run == full.cell_steps_bound
    for fld in ("throughput", "time", "mem_stall_total", "mem_accesses"):
        assert np.array_equal(getattr(coh, fld), getattr(mono, fld)), fld
        assert np.array_equal(getattr(coh, fld)[:, 1:], getattr(full, fld))
    assert coh.steps <= mono.steps


def test_prelowered_arrays_and_substeps_do_not_change_results(
        exit_every_chunk, hash_small):
    cfg = SimConfig(P=12, seed=7)
    a = rt.sweep_grid(cfg, hash_small, [5 * US], [8], n_ops=100,
                      device="cpu")
    b = rt.sweep_grid(cfg, rt.lower_trace(hash_small, bucket=4096),
                      [5 * US], [8], n_ops=100, device="cpu", substeps=8)
    assert np.array_equal(a.throughput, b.throughput)
    assert a.result(0, 0).throughput == float(a.throughput[0, 0])
    assert a.result(0, 0).latency_summary is None


# -- 5. validation -------------------------------------------------------------


def test_sweep_grid_value_errors(hash_small):
    g = partial(rt.sweep_grid, device="cpu")
    with pytest.raises(ValueError, match="tag"):
        g(SimConfig(n_cores=4), hash_small, [1 * US], [128])
    with pytest.raises(ValueError, match="n_cores"):
        g(SimConfig(n_cores=0), hash_small, [1 * US], [8])
    with pytest.raises(ValueError, match="scalar latencies"):
        g(SimConfig(), hash_small, [[(5 * US, 1.0)]], [8])
    with pytest.raises(ValueError, match="histograms"):
        g(SimConfig(collect_load_hist=True), hash_small, [1 * US], [8])
    with pytest.raises(ValueError, match="empty"):
        g(SimConfig(), hash_small, [], [8])
    with pytest.raises(ValueError, match="empty"):
        g(SimConfig(), hash_small, [1 * US], [])
    with pytest.raises(ValueError, match=">= 1"):
        g(SimConfig(), hash_small, [1 * US], [0, 8])
    with pytest.raises(ValueError, match="n_ssd"):
        g(dataclasses.replace(SimConfig(), n_ssd=0), hash_small, [1 * US],
          [8])
    for bad in (0, 3, 2048):
        with pytest.raises(ValueError, match="substeps"):
            g(SimConfig(), hash_small, [1 * US], [8], substeps=bad)
    with pytest.raises(ValueError, match="use_kernel=True needs a CUDA"):
        g(SimConfig(), hash_small, [1 * US], [8], use_kernel=True)
    with pytest.raises(ValueError, match="arrivals"):
        g(SimConfig(), hash_small, [1 * US], [8], n_ops=400,
          arrivals=np.zeros(3))
    with pytest.raises(ValueError, match="arrivals"):
        g(SimConfig(), hash_small, [1 * US], [8], arrivals=np.zeros((2, 2)))
    with pytest.raises(ValueError, match="deadline"):
        g(SimConfig(), hash_small, [1 * US], [8], deadline=-1.0)


def test_under_run_raises_runtime_error(monkeypatch, hash_small):
    monkeypatch.setattr(rt, "_steps_bound",
                        lambda trace, n_ops, warm, thr: 1024)
    with pytest.raises(RuntimeError, match="under-ran its step bound"):
        rt.sweep_grid(SimConfig(P=12), hash_small, [1 * US], [8],
                      n_ops=2000, device="cpu")


def test_grid_tol_law():
    """The law has one home, the port's conformance module, and is the
    reference's ``jax_grid_tol``; the grid module keeps no copy."""
    from repro.core.conformance import jax_grid_tol
    for n in (100, 600, 5000, 20_000, 80_000):
        assert grid_tol(n) == pytest.approx(jax_grid_tol(n), rel=1e-15)
        assert grid_tol(n, slack=1.25) == pytest.approx(
            jax_grid_tol(n, slack=1.25), rel=1e-15)
    assert not hasattr(rt, "grid_tol") and not hasattr(rt, "GRID_TOL")
