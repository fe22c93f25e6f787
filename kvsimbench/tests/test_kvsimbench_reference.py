"""The plain reference against the program on the CPU, at a tiny size.

For both engines and both traffic mixes, the reference's trace equals the
program's engine walk of the same keys, and each cell of
``replay_torch.sweep_grid(device="cpu")`` (the plain PyTorch step the CUDA
kernel is held to bit for bit) equals the reference's event loop: every
float bit for bit, the percentiles within one ulp (the bin midpoint's
power: NumPy's vectorised ``**`` and Python's may round apart).
"""
import math

import pytest

from kvsimbench import bench, check, deployment
from kvsimbench.reference import arrivals as ref_arrivals
from kvsimbench.reference import engines as ref_engines
from kvsimbench.reference import trace as ref_trace
from kvsimbench.reference import workloads as ref_workloads
from kvsimbench.reference.scheduler import run_cell
from repro_torch.core.engines import get_engine, run_trace
from repro_torch.core.sim import SimConfig
from repro_torch.core.sim.replay_torch import sweep_grid
from repro_torch.core.workloads import Workload, create_workload

N_KEYS, N_WL = 2000, 800
LATS = [0.5e-6, 4e-6]
THREADS = [3, 8]
N_OPS = 150

ENGINES = {"hash-index": ("uniform", {}, {"seed": 5}),
           "lsm": ("zipf", {"exponent": 0.99}, {})}


def traces(engine, seed=11, read_write=(1, 0)):
    wl, wkw, ekw = ENGINES[engine]
    keys, w = ref_workloads.get(wl)(N_KEYS, N_WL, seed=seed,
                                    read_write=read_write, **wkw)
    prog = run_trace(get_engine(engine)(N_KEYS, **ekw),
                     Workload(wl, keys, w, N_KEYS), 0.3).trace
    ref, _ = ref_trace.run_trace(ref_engines.get(engine)(N_KEYS, **ekw),
                                 keys, w, 0.3)
    return prog, ref


@pytest.mark.parametrize("engine", sorted(ENGINES))
@pytest.mark.parametrize("read_write", [(1, 0), (2, 1)])
def test_trace_equals_the_programs(engine, read_write):
    prog, ref = traces(engine, read_write=read_write)
    assert check.trace_gap(prog, ref) == 0
    assert ref.n_ops == int(N_WL * 0.7)


@pytest.mark.parametrize("name,kw", [("uniform", {}),
                                     ("zipf", {"exponent": 0.99})])
def test_key_streams_equal_the_programs(name, kw):
    keys, w = ref_workloads.get(name)(N_KEYS, N_WL, seed=9,
                                      read_write=(3, 1), **kw)
    p = create_workload(name, N_KEYS, N_WL, seed=9, read_write=(3, 1), **kw)
    assert (keys == p.keys).all() and (w == p.is_write).all()


def sim_of(cfg, deadline=0.0):
    return dict(T_sw=cfg.T_sw, P=cfg.P, L_io=cfg.L_io,
                L_io_jitter=cfg.L_io_jitter, n_ssd=cfg.n_ssd, R_io=cfg.R_io,
                B_io=cfg.B_io, A_io=cfg.A_io, L_switch=cfg.L_switch,
                eps=cfg.eps, rho=cfg.rho, L_dram=cfg.L_dram, B_mem=cfg.B_mem,
                A_mem=cfg.A_mem, T_lock=cfg.T_lock, io_degrade=cfg.io_degrade,
                T_degrade=cfg.T_degrade, deadline=deadline)


def assert_grid_equals_reference(g, ref, cfg, arr, deadline=0.0):
    collect = g.p50 is not None
    for li, L in enumerate(LATS):
        for ci, t in enumerate(THREADS):
            c = run_cell(ref, sim_of(cfg, deadline), L, t, N_OPS, cfg.seed,
                         arrivals=arr, collect=collect)
            assert g.throughput[li, ci] == c.throughput
            assert g.time[li, ci] == c.time
            assert g.mem_stall_total[li, ci] == c.mem_stall_total
            assert g.mem_accesses[li, ci] == c.mem_accesses
            if not collect:
                continue
            s = c.summary()
            assert g.lat_count[li, ci] == s["count"]
            assert g.missed[li, ci] == s["missed"]
            assert g.lat_max[li, ci] == s["max"]
            assert list(g.lat_hist[li, ci]) == c.hist
            for q in ("p50", "p90", "p99"):
                assert check.rel_gap(getattr(g, q)[li, ci], s[q]) <= 2**-52


@pytest.mark.parametrize("engine", sorted(ENGINES))
@pytest.mark.parametrize("mix", ["fig_closed", "fig_open"])
def test_cells_equal_the_plain_step(engine, mix):
    prog, ref = traces(engine)
    cfg = SimConfig(P=12, T_sw=0.05e-6, seed=2**40 + 17, n_ssd=2,
                    R_io=250000.0, L_switch=0.3e-6)
    arr = None
    if mix == "fig_open":
        spec = {"kind": "poisson", "rate": 60000.0, "seed": 99}
        need = max(t + 2 * t + N_OPS for t in THREADS) + 1
        arr = ref_arrivals.get("poisson")(spec, need)
    g = sweep_grid(cfg, prog, LATS, THREADS, N_OPS, device="cpu",
                   arrivals=arr, collect_percentiles=arr is not None)
    assert_grid_equals_reference(g, ref, cfg, arr)


def test_every_setting_the_reference_reads():
    """Re-fetches, a DRAM tier, a lock, a prefetch bandwidth clock, an IO
    bandwidth clock, a degraded SSD and a deadline, on a 2:1 mix."""
    prog, ref = traces("lsm", read_write=(2, 1))
    cfg = SimConfig(P=12, T_sw=0.05e-6, seed=31, n_ssd=2, R_io=250000.0,
                    L_switch=0.3e-6, eps=0.05, rho=0.7, T_lock=0.2e-6,
                    B_mem=2e9, io_degrade=1.5, T_degrade=1e-4, B_io=3e8)
    spec = {"kind": "poisson", "rate": 60000.0, "seed": 5}
    arr = ref_arrivals.get("poisson")(spec, 200)
    g = sweep_grid(cfg, prog, LATS, THREADS, N_OPS, device="cpu",
                   arrivals=arr, collect_percentiles=True, deadline=2e-4)
    assert g.missed.sum() > 0
    assert_grid_equals_reference(g, ref, cfg, arr, deadline=2e-4)


def test_arrivals_equal_the_programs():
    from repro_torch.core.sim import generate_arrivals
    spec = {"kind": "poisson", "rate": 367200.0, "seed": 2**45 + 3}
    assert (ref_arrivals.get("poisson")(spec, 5000)
            == generate_arrivals(dict(spec), 5000)).all()


def test_reference_row_picks_the_first_best():
    """Equal throughputs: the first thread count wins, as in
    ``sweep_latency``; a closed-loop row has no percentiles."""
    cell = bench.cell("hash_fig_closed")
    inp = deployment.make(cell["config_doc"], cell["traffic_doc"], 1, {
        "config": {"n_keys": N_KEYS, "n_wl_ops": N_WL},
        "traffic": {"latencies_us": [0.5], "threads": [3, 3],
                    "n_ops": N_OPS}})
    tr, _ = check.reference_trace(inp)
    row = check.reference_row(inp, tr, 1, 0)
    assert row["per_thread"][0][0] == row["per_thread"][0][1]
    assert row["best"][0] == 3
    assert check.reduction_faults(row, inp.threads) == 0
    assert math.isnan(row["tail"][0][0])
