"""One benchmark per paper figure/table (Figs. 3, 10-18, Table 6), on the port.

The PyTorch / CUDA port's counterpart of ``benchmarks/paper_figs.py``: the
same twelve functions in the same ``ALL`` order, with the same row names and
derived fields, over :mod:`repro_torch`.  Each ``fig_*`` function reproduces
the measurement protocol of its figure with the discrete-event simulator
standing in for the FPGA testbed, and prints CSV rows;
``benchmarks.run_torch`` calls them all.

Every latency sweep goes through :mod:`benchmarks.common_torch`, so it runs
on the CLI's backend and device (``BACKEND`` / ``DEVICE``; default the
torch grid on the card):

* on the grid: fig11 (microbenchmark and engines), fig13, fig15, and the
  scalar-latency cells of table6 and fig18 (their flash tail-latency
  mixture runs through the host's compiled loop, as every mixture cell of a
  torch sweep does);
* on the host, as in the reference: fig3 (analytic), fig10
  (``collect_load_hist``), fig12 and fig16 (single-cell ``simulate``),
  fig14 (multi-core ``simulate_compiled``) and fig17 (``collect_latency``)
  -- the grid collects neither load histograms nor per-op latencies.

The microbenchmark's source is one repeated op; the grid replays compiled
traces, not callables, so fig11(a)(b) sweep it as a one-op trace on both
backends, and the loop's numbers there differ from the reference's
callable by sampling noise (``docs/PORT.md``, departure C16).
"""
from __future__ import annotations

import random

import numpy as np

from repro_torch.core import workloads
from repro_torch.core.engines import LSMStore, TreeIndexStore, TwoTierCacheStore, run_trace
from repro_torch.core.experiment import Experiment, default_scenario
from repro_torch.core.latency_model import (
    US,
    OpParams,
    PAPER_EXAMPLE,
    SystemParams,
    cost_performance_ratio,
    theta_mask_inv,
    theta_mem_inv,
    theta_multi_inv,
    theta_prob_inv,
    theta_single_inv,
)
from repro_torch.core.sim import (
    SimConfig,
    microbenchmark_source,
    simulate,
    simulate_compiled,
    sweep_latency,
)
from repro_torch.core.tiering import FLASH_CXL

from . import common_torch as common
from .common_torch import (
    L_SWEEP_US,
    N_CANDIDATES,
    build_engine,
    build_engines,
    emit,
    engine_trace,
    run_options,
    sweep_points,
)

#: the paper's three modified stores (Figs. 11/13); the matrix figure widens
#: this to every registered engine
PAPER_ENGINES = ("aerospike-like", "rocksdb-like", "cachelib-like")


def fig3_model_curves() -> None:
    """Fig. 3: normalized throughput of the four analytical models."""
    L = np.array(L_SWEEP_US) * US
    p = PAPER_EXAMPLE
    curves = {
        "single": theta_single_inv(L, p),
        "multi-unlimited": theta_multi_inv(L, p),
        "mem-P-limited": theta_mem_inv(L, p),
        "masking-only": theta_mask_inv(L, p),
        "probabilistic": theta_prob_inv(L, p),
    }
    for name, inv in curves.items():
        base = inv[0]
        for l_us, v in zip(L_SWEEP_US, inv):
            emit(f"fig3/{name}/L{l_us}us", v / US, f"norm={base / v:.4f}")


def fig10_load_latency() -> None:
    """Fig. 10: load-latency distribution (stall histogram), normal and
    cache-constrained (eps) conditions."""
    src = microbenchmark_source(10, 0.1 * US, 1.5 * US, 0.2 * US)
    for tag, eps in (("60MB-L3", 0.0), ("4MB-L3", 0.05)):
        cfg = SimConfig(L_mem=10 * US, n_threads=48, eps=eps, seed=3,
                        collect_load_hist=True)
        r = simulate(cfg, src, 8000)
        st = np.array(r.load_stalls)
        frac0 = float((st < 0.05 * US).mean())
        frac_tail = float((st > 8 * US).mean())
        emit(f"fig10/{tag}", 1e6 / r.throughput,
             f"zero_stall={frac0:.4f};full_latency_tail={frac_tail:.5f}")


def fig11_microbenchmark() -> None:
    """Fig. 11(a)(b): microbenchmark vs models, two parameter combos."""
    combos = {
        "a": OpParams(M=10, T_io_pre=1.5 * US, T_io_post=0.2 * US, P=12),
        "b": OpParams(M=10, T_io_pre=3.5 * US, T_io_post=2.2 * US, P=12),
    }
    for tag, p in combos.items():
        src = microbenchmark_source(int(p.M), p.T_mem, p.T_io_pre, p.T_io_post)
        # the one op as a one-op trace: the grid replays traces, and both
        # backends then replay the same apparatus (C16)
        pts = sweep_points([src(random.Random(0))], L_SWEEP_US,
                           N_CANDIDATES, n_ops=5000, P=p.P, seed=5,
                           T_sw=p.T_sw)
        errs = []
        for l_us, pt in pts.items():
            L = np.array([l_us * US])
            prob = 1 / theta_prob_inv(L, p)[0]
            mask = 1 / theta_mask_inv(L, p)[0]
            errs.append(pt.throughput / prob - 1)
            emit(f"fig11{tag}/L{l_us}us", 1e6 / pt.throughput,
                 f"sim_over_prob={pt.throughput / prob:.4f};"
                 f"sim_over_mask={pt.throughput / mask:.4f}")
        emit(f"fig11{tag}/max_model_err", 0.0,
             f"max_abs_rel={max(abs(e) for e in errs):.4f}")


def fig11_kvstores() -> None:
    """Fig. 11(c)(d)(e): the three engines vs models (single core)."""
    for name, (store, wl) in build_engines(names=PAPER_ENGINES).items():
        tr, p, trace = engine_trace(name, store, wl)
        pts = sweep_points(trace, (0.1, 1, 3, 5, 8, 10), N_CANDIDATES,
                           n_ops=5000, P=p.P, seed=7)
        base = None
        for l_us, pt in pts.items():
            if base is None:
                base = pt.throughput
            L = np.array([l_us * US])
            prob = 1 / theta_prob_inv(L, p)[0]
            emit(f"fig11/{name}/L{l_us}us", 1e6 / pt.throughput,
                 f"norm={pt.throughput / base:.4f};"
                 f"sim_over_prob={pt.throughput / prob:.4f}")
        emit(f"fig11/{name}/params", 0.0,
             f"M={p.M:.1f};S={p.S:.3f};Tmem_us={p.T_mem / US:.3f}")


def fig12_extended() -> None:
    """Fig. 12: scenarios where other limits bind; extended model tracks."""
    p = PAPER_EXAMPLE
    src = microbenchmark_source(10, p.T_mem, p.T_io_pre, p.T_io_post)

    # (a) SSD bandwidth-limited (one SSD, big IOs)
    cfg = SimConfig(L_mem=1 * US, n_threads=64, A_io=65536, B_io=2e9, seed=3)
    r = simulate(cfg, src, 4000)
    cap = 2e9 / 65536
    emit("fig12a/ssd_bw", 1e6 / r.throughput,
         f"cap_frac={r.throughput / cap:.3f}")

    # (b) SSD IOPS-limited (slow SATA)
    cfg = SimConfig(L_mem=1 * US, n_threads=64, R_io=75e3, seed=3)
    r = simulate(cfg, src, 4000)
    emit("fig12b/ssd_iops", 1e6 / r.throughput,
         f"cap_frac={r.throughput / 75e3:.3f}")

    # (c) memory-bandwidth throttled
    cfg = SimConfig(L_mem=1 * US, n_threads=64, A_mem=64, B_mem=64 / (0.3 * US),
                    seed=3)
    r = simulate(cfg, src, 4000)
    emit("fig12c/mem_bw", 1e6 / r.throughput,
         f"cap_frac={r.throughput / (1 / (10 * 0.3 * US)):.3f}")

    # (d) small CPU cache: premature eviction
    for eps in (0.0, 0.05):
        cfg = SimConfig(L_mem=5 * US, n_threads=48, eps=eps, seed=3)
        r = simulate(cfg, src, 4000)
        pred = 1 / theta_prob_inv(np.array([5 * US]), p,
                                  sysp=SystemParams(eps=eps))[0]
        emit(f"fig12d/eps{eps}", 1e6 / r.throughput,
             f"sim_over_model={r.throughput / pred:.3f}")

    # (e) tiering rho
    for rho in (1.0, 0.7, 0.3):
        cfg = SimConfig(L_mem=8 * US, n_threads=48, rho=rho, seed=3)
        r = simulate(cfg, src, 4000)
        pred = 1 / theta_prob_inv(np.array([8 * US]), p,
                                  sysp=SystemParams(rho=rho))[0]
        emit(f"fig12e/rho{rho}", 1e6 / r.throughput,
             f"sim_over_model={r.throughput / pred:.3f}")


def fig14_multicore() -> None:
    """Fig. 14: multi-core scaling at 5 us with lock contention."""
    store, wl = build_engine("aerospike-like")
    tr, p, trace = engine_trace("aerospike-like", store, wl)
    base = None
    for cores in (1, 2, 4, 8, 16):
        cfg = SimConfig(L_mem=5 * US, n_threads=32, n_cores=cores,
                        T_lock=0.15 * US, R_io=2.2e6, seed=9)
        r = simulate_compiled(cfg, trace, 3000 * cores)
        if base is None:
            base = r.throughput
        emit(f"fig14/{cores}cores", 1e6 / r.throughput * cores,
             f"speedup={r.throughput / base:.2f}")


def fig15_settings() -> None:
    """Fig. 15: setting variations; geomean degradation at 5 us (paper: 8%)."""
    nk, nops = 60_000, 20_000
    variants = {
        "tree/uniform-ro": (TreeIndexStore(nk, seed=1),
                            workloads.uniform(nk, nops, (1, 0), 2)),
        "tree/zipf1.1-ro": (TreeIndexStore(nk, seed=1),
                            workloads.zipf(nk, nops, 1.1, (1, 0), 2)),
        "tree/uniform-w21": (TreeIndexStore(nk, seed=1),
                             workloads.uniform(nk, nops, (2, 1), 2)),
        "lsm/zipf0.99-ro": (LSMStore(nk), workloads.zipf(nk, nops, 0.99, (1, 0), 3)),
        "lsm/zipf0.8-ro": (LSMStore(nk), workloads.zipf(nk, nops, 0.8, (1, 0), 3)),
        "lsm/zipf0.99-w21": (LSMStore(nk), workloads.zipf(nk, nops, 0.99, (2, 1), 3)),
        "cache/gauss-w21": (TwoTierCacheStore(nk, seed=4),
                            workloads.gaussian(nk, nops, 0.08, (2, 1), 5)),
        "cache/gcl-w11": (TwoTierCacheStore(nk, seed=4),
                          workloads.graph_cache_leader(nk, nops, (1, 1), 5)),
    }
    degs = []
    for name, (store, wl) in variants.items():
        tr, p, trace = engine_trace(name, store, wl)
        pts = sweep_points(trace, (0.1, 5.0), (24, 40, 56), n_ops=4000,
                           P=p.P, seed=11)
        thr = {l_us: pt.throughput for l_us, pt in pts.items()}
        d = 1 - thr[5.0] / thr[0.1]
        degs.append(max(d, 1e-4))
        emit(f"fig15/{name}", 1e6 / thr[5.0], f"degradation_at_5us={d:.4f}")
    geo = float(np.exp(np.mean(np.log(degs))))
    emit("fig15/geomean_degradation", 0.0, f"geomean={geo:.4f}")


def fig16_threads() -> None:
    """Fig. 16: throughput vs thread count (stability of the peak)."""
    p = PAPER_EXAMPLE
    src = microbenchmark_source(10, p.T_mem, p.T_io_pre, p.T_io_post)
    for l_us in (1.0, 5.0):
        vals = []
        for n in (8, 16, 24, 32, 48, 64, 96):
            r = simulate(SimConfig(L_mem=l_us * US, n_threads=n, seed=13),
                         src, 4000)
            vals.append(r.throughput)
            emit(f"fig16/L{l_us}us/N{n}", 1e6 / r.throughput,
                 f"thr_kops={r.throughput / 1e3:.1f}")
        peak_region = max(vals) / np.mean(sorted(vals)[-4:])
        emit(f"fig16/L{l_us}us/peak_stability", 0.0, f"max_over_top4mean={peak_region:.3f}")


def fig17_op_latency() -> None:
    """Fig. 17: KV operation latency grows mildly with memory latency."""
    store, wl = build_engine("aerospike-like")
    tr, p, trace = engine_trace("aerospike-like", store, wl)
    base = None
    for l_us in (0.1, 2, 5, 10):
        cfg = SimConfig(L_mem=l_us * US, n_threads=32, seed=15)
        r = simulate_compiled(cfg, trace, 4000, collect_latency=True)
        lat = r.mean_op_latency
        if base is None:
            base = lat
        emit(f"fig17/L{l_us}us", lat / US, f"latency_ratio={lat / base:.2f}")


def table6_cpr() -> None:
    """Table 6: cost-performance ratios, with the tail-latency profile of
    Sec. 5.1 driving the measured degradation d for flash."""
    store, wl = build_engine("aerospike-like")
    tr, p, trace = engine_trace("aerospike-like", store, wl)
    thr = {}
    for tag, lmem in (("dram", 0.1 * US), ("flash", FLASH_CXL.latency_spec())):
        cfg = SimConfig(P=p.P, seed=17)
        (pt,) = sweep_latency(cfg, trace, [lmem], N_CANDIDATES, n_ops=5000,
                              backend=common.BACKEND, device=common.DEVICE)
        thr[tag] = pt.throughput
    d_flash = 1 - thr["flash"] / thr["dram"]
    emit("table6/flash_tail_degradation", 1e6 / thr["flash"], f"d={d_flash:.4f}")
    for name, b, d in (
        ("compressed-dram-lo", 1 / 2, 0.02),
        ("compressed-dram-hi", 1 / 3, 0.0),
        ("flash-lo", 0.2, max(d_flash, 0.02)),
        ("flash-hi", 0.15, 0.02),
    ):
        r = cost_performance_ratio(0.4, b, d)
        emit(f"table6/cpr/{name}", 0.0, f"r={r:.3f}")


def fig18_capacity() -> None:
    """Fig. 18: spend the DRAM savings on capacity: a 4x larger block cache
    on microsecond memory beats the small DRAM-only cache."""
    nk, nops = 200_000, 30_000
    wl = workloads.zipf(nk, nops, 0.7, (1, 0), seed=19)
    small = LSMStore(nk, cache_blocks=nk // 10 // 12)   # DRAM-sized cache
    big = LSMStore(nk, cache_blocks=4 * (nk // 10 // 12))
    tr_s = run_trace(small, wl)
    tr_b = run_trace(big, wl)
    p_s = tr_s.op_params(small.times, 12, 0.05 * US)
    p_b = tr_b.op_params(big.times, 12, 0.05 * US)
    (pt_small,) = sweep_latency(SimConfig(seed=21), tr_s.trace,
                                [0.1 * US], N_CANDIDATES, n_ops=5000,
                                backend=common.BACKEND, device=common.DEVICE)
    (pt_big,) = sweep_latency(SimConfig(seed=21), tr_b.trace,
                              [FLASH_CXL.latency_spec()], N_CANDIDATES,
                              n_ops=5000, backend=common.BACKEND,
                              device=common.DEVICE)
    r_small, r_big = pt_small.result, pt_big.result
    gain = r_big.throughput / r_small.throughput - 1
    emit("fig18/lsm_small_dram", 1e6 / r_small.throughput,
         f"hit={tr_s.hit_stats['block_cache']:.3f}")
    emit("fig18/lsm_big_cxl", 1e6 / r_big.throughput,
         f"hit={tr_b.hit_stats['block_cache']:.3f};gain={gain:+.3f}")


def fig13_engine_matrix() -> None:
    """Engine x device matrix: the paper's key qualitative result across the
    full registry.  One latency-tolerance curve per (engine, SSD count) --
    IO-rich engines (hash index: S=1) stay near-flat out to 10 us while
    cache engines with high hit rates (few IOs to hide behind) degrade
    fastest; doubling the SSDs moves every IOPS-bound curve up without
    changing its latency-tolerance shape.  Each cell is one declarative
    scenario through the public experiment API."""
    lats = (0.1, 1, 5, 10)
    cands = (24, 40, 56)
    for engine in ("tree-index", "lsm", "two-tier-cache", "hash-index",
                   "slab-cache"):
        for n_ssd in (1, 2):
            sc = default_scenario(engine, n_ssd=n_ssd, latencies_us=lats,
                                  thread_candidates=cands, n_ops=4000)
            art = Experiment(sc, run_options()).run()
            base = art.baseline_throughput
            for row in art.rows:
                emit(f"fig13/{engine}/ssd{n_ssd}/{row.label()}",
                     1e6 / row.throughput,
                     f"norm={row.throughput / base:.4f}")
            d10 = 1 - art.rows[-1].throughput / base
            emit(f"fig13/{engine}/ssd{n_ssd}/degradation_at_10us", 0.0,
                 f"d={d10:.4f};S={art.S:.3f};M={art.M:.2f}")


ALL = [
    fig3_model_curves,
    fig10_load_latency,
    fig11_microbenchmark,
    fig11_kvstores,
    fig12_extended,
    fig13_engine_matrix,
    fig14_multicore,
    fig15_settings,
    fig16_threads,
    fig17_op_latency,
    table6_cpr,
    fig18_capacity,
]
