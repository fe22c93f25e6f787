"""Tolerance equivalence of the port's grid, on its own random streams,
against the port's host interpreter loop (``simulate_compiled``, itself
bit-identical to the reference's -- ``test_torch_core_copies.py``).

The grid draws from a counter-based generator, the loop from the Mersenne
twister, so cells agree to sampling noise: per-cell throughput within
``grid_tol(n_ops)`` = ``1% * sqrt(20000 / n_ops)`` (the reference's
``jax_grid_tol`` law), times the reference's 1.25 slack for non-default
device features and 1.1 for multi-core.  Cells are small here (the plain
step costs about a millisecond on the CPU), so the bound is wide; the card
run in ``chip_smoke.py`` holds 5000-op cells to 2 %.
"""
import dataclasses

import numpy as np
import pytest

from repro_torch.core.sim import SimConfig, simulate_compiled
from repro_torch.core.conformance import grid_tol
from repro_torch.core.sim import replay_torch as rt

from _torch_port_support import US, engine_trace

N_OPS = 600


@pytest.fixture(scope="module")
def hash_small():
    return engine_trace("hash-index").trace


def _worst(cfg, trace, lats, cands, n_ops):
    grid = rt.sweep_grid(cfg, trace, lats, cands, n_ops=n_ops, device="cpu")
    worst = 0.0
    for li, L in enumerate(lats):
        for ci, n in enumerate(cands):
            ref = simulate_compiled(
                dataclasses.replace(cfg, L_mem=L, n_threads=n), trace, n_ops)
            worst = max(worst, abs(grid.throughput[li, ci] - ref.throughput)
                        / ref.throughput)
            assert grid.ops == ref.ops == n_ops
    return worst, grid


FEATURES = [
    dict(),
    dict(eps=0.05),
    dict(rho=0.9),
    dict(T_lock=0.1 * US),
    dict(A_mem=64, B_mem=64 / (0.5 * US)),
    dict(R_io=250e3),
    dict(n_ssd=2, R_io=250e3, B_io=400e6, L_switch=0.3 * US),
]


@pytest.mark.parametrize("kw", FEATURES,
                         ids=[",".join(k) or "default" for k in FEATURES])
def test_device_features_close_to_loop(hash_small, kw):
    cfg = SimConfig(P=12, seed=7, **kw)
    worst, _ = _worst(cfg, hash_small, [1 * US, 5 * US], [6, 8], N_OPS)
    assert worst < grid_tol(N_OPS, slack=1.25), f"{kw}: {worst:.2%}"


def test_multicore_close_to_loop(hash_small):
    cfg = SimConfig(P=12, seed=7, n_cores=2, T_lock=0.1 * US)
    worst, _ = _worst(cfg, hash_small, [1 * US, 5 * US], [3, 4], N_OPS)
    assert worst < grid_tol(N_OPS, slack=1.25), f"{worst:.2%}"


def test_mem_counters_track_loop(hash_small):
    cfg = SimConfig(P=12, seed=7)
    grid = rt.sweep_grid(cfg, hash_small, [5 * US], [8], n_ops=N_OPS,
                         device="cpu")
    ref = simulate_compiled(
        dataclasses.replace(cfg, L_mem=5 * US, n_threads=8), hash_small,
        N_OPS)
    assert abs(grid.mem_accesses[0, 0] - ref.mem_accesses) \
        / ref.mem_accesses < 0.03
    assert abs(grid.mem_stall_total[0, 0] - ref.mem_stall_total) \
        / ref.mem_stall_total < 0.15


def test_open_loop_tail_close_to_loop(hash_small):
    """Poisson arrivals at about half the cell's capacity, percentiles on:
    the histogram percentiles sit within the reference's documented tail
    bounds (8 % p50, 12 % p99 at 400 ops) of the loop's exact ones."""
    from repro_torch.core.sim import ArrivalSpec, generate_arrivals
    cfg = SimConfig(P=12, seed=7, R_io=250e3)
    arr = generate_arrivals(ArrivalSpec(kind="poisson", rate=45e3, seed=2),
                            N_OPS + 64)
    grid = rt.sweep_grid(cfg, hash_small, [2 * US], [8], n_ops=N_OPS,
                         device="cpu", arrivals=arr,
                         collect_percentiles=True)
    ref = simulate_compiled(
        dataclasses.replace(cfg, L_mem=2 * US, n_threads=8), hash_small,
        N_OPS, arrivals=arr, collect_percentiles=True)
    s = ref.latency_summary
    assert grid.lat_count[0, 0] == s.count == N_OPS
    assert abs(grid.p50[0, 0] - s.p50) / s.p50 < 0.08
    assert abs(grid.p99[0, 0] - s.p99) / s.p99 < 0.12
    assert abs(grid.lat_max[0, 0] - s.max) / s.max < 0.25
    assert abs(grid.throughput[0, 0] - ref.throughput) / ref.throughput \
        < grid_tol(N_OPS)
    assert np.isfinite(grid.lat_hist).all() and grid.lat_hist.sum() == N_OPS
