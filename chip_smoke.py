#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``repro_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

It builds the CUDA kernels from ``src/repro_torch/kernels/csrc/`` with
``nvcc``, holds each kernel against its plain PyTorch version on the card,
drives the port's main path -- one ``Scenario`` through ``Experiment.run``
with every scalar-latency grid cell stepped by the fused CUDA kernel -- at
real size, drives the plain-step path (which launches the standalone
token-clock kernel) on one cohort of the same grid in a counted window of its
own, checks the results against the host interpreter loop, times the kernels,
and prints one JSON object per phase.  The last line is
``{"ok": true, "device": {...}}``.  Any failing phase exits non-zero; there
is no CPU fallback: without a CUDA device the script fails.
"""
import json
import math
import subprocess
import sys
import time
from dataclasses import replace
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tests"))     # the kernel-vs-plain check cases

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke: no CUDA device is available; this script runs the "
             "port on an NVIDIA GPU and has no CPU fallback")

from repro_torch.core.engines import run_trace
from repro_torch.core.experiment import Experiment, RunOptions, Scenario
from repro_torch.core.sim import generate_arrivals, simulate_compiled
from repro_torch.core.sim import replay_torch as rt
from repro_torch.kernels import _build
from repro_torch.kernels import sched_step as sk
from repro_torch.kernels import token_clock as tc

import _torch_kernel_cases as cases

US = 1e-6
DEV = torch.device("cuda", 0)

# Main-path grid: the scenario's own trace over the reference's "mega"
# sweep axes -- 128 latencies from 0.1 to 10 us x threads (8, 16, 32, 64).
N_LATS = 128
CANDS = (8, 16, 32, 64)

# Published peaks of one H100 SXM (dense): device memory rate, and the
# float64 rate outside the tensor cores (half the 67 TFLOP/s float32 rate).
HBM_BYTES_PER_S = 3.35e12
F64_FLOP_PER_S = 33.5e12

# The serial chain of one scheduler step, as a model (assumed cycle counts,
# not measured here): the least latency of the operations that the next
# step's clock depends on -- the ring pop (key select, then 5 warp-shuffle
# rounds of a 64-bit min), the popped thread's row from shared memory, the
# span unpacking, one gather of its suboperation from the trace table (an L2
# hit) and the float64 operations from there to ``now + T_sw``.
CHAIN = {"shuffle_rounds": 5, "cycles_per_shuffle_round": 25,
         "shared_loads": 1, "cycles_per_shared_load": 30,
         "l2_gathers": 1, "cycles_per_l2_gather": 200,
         "f64_ops": 11, "cycles_per_f64_op": 8}
CHAIN_CYCLES = sum(CHAIN[n] * CHAIN[c] for n, c in (
    ("shuffle_rounds", "cycles_per_shuffle_round"),
    ("shared_loads", "cycles_per_shared_load"),
    ("l2_gathers", "cycles_per_l2_gather"),
    ("f64_ops", "cycles_per_f64_op")))

OUT_DIR = ROOT / "chiprun_out"
PHASES = []


def emit(name, **fields):
    line = {"phase": name, **fields}
    PHASES.append(line)
    print(json.dumps(line), flush=True)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(fn, reps):
    """Mean milliseconds of ``fn()`` over ``reps`` calls, by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def reset_counts():
    sk.fused_steps.launches = 0
    tc.token_clock_update.launches = 0


def state_bytes(state):
    return sum(p.numel() * p.element_size() for p in state)


# -- phases --------------------------------------------------------------------


def phase_card():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    clk = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60)
    if clk.returncode != 0:
        fail(f"nvidia-smi failed: {clk.stderr.strip()}")
    sm_mhz = float(clk.stdout.strip().splitlines()[0])
    emit("card", card=card, sm_clock_max_mhz=sm_mhz, torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0],
         sm_count=torch.cuda.get_device_properties(0).multi_processor_count)
    return card, sm_mhz


def phase_build():
    info = _build.build_all(verbose=True)
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "nvcc_ptxas.log").write_text(info["log"] + "\n")
    for name in _build.KERNEL_SOURCES:
        _build.load(name)
    regs = [ln.strip() for ln in info["log"].splitlines()
            if "registers" in ln]
    emit("build", seconds=round(info["seconds"], 3), built=info["built"],
         nvcc_flags=info["flags"], dir=str(_build.build_dir().relative_to(ROOT)),
         ptxas=regs[:12])


def phase_token_clock(G, S):
    """The standalone token-clock kernel against its plain version at the
    main path's plane shape, then its time, the plain version's, its bound."""
    rng = np.random.default_rng(101)
    t = lambda a: torch.from_numpy(a).to(DEV)  # noqa: E731
    worst = 0.0
    for inv_r, cost in ((1 / 250e3, 0.0), (1 / 250e3, 1024 / 400e6),
                        (0.0, 1024 / 400e6), (0.0, 0.0)):
        submit = t(rng.random(G) * 1e-3)
        dev_ix = rng.integers(0, S, G)
        mask_np = (np.arange(S)[None, :] == dev_ix[:, None]) \
            & (rng.random(G) < 0.6)[:, None]
        mask = t(mask_np)
        tok = t(rng.random((G, S)) * 1e-3)
        bw = t(rng.random((G, S)) * 1e-3)
        got = tc.token_clock_update(submit, mask, tok, bw, inv_r, cost)
        want = tc.token_clock_update_ref(submit, mask, tok, bw, inv_r, cost)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            if not torch.equal(a.view(torch.int64), b.view(torch.int64)):
                worst = max(worst, float((a - b).abs().max()))
    if worst != 0.0:
        fail(f"token_clock_update disagrees with its plain version "
             f"(max abs err {worst})")
    args = (submit, mask, tok, bw, 1 / 250e3, 1024 / 400e6)
    tc.token_clock_update(*args)
    ms = cuda_ms(lambda: tc.token_clock_update(*args), 200)
    plain_ms = cuda_ms(lambda: tc.token_clock_update_ref(*args), 200)
    # bytes: submit + devmask(int32) + tok + bw in; svc + tok + bw out
    nbytes = 8 * G + 4 * G * S + 2 * 8 * G * S + 8 * G + 2 * 8 * G * S
    flops = G * (4 + 2 * S)          # two max, two add, S-term mask sums
    b_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    b_ops = flops / F64_FLOP_PER_S * 1e3
    return dict(
        name="token_clock.token_clock_update", route="cuda",
        source="src/repro_torch/kernels/csrc/token_clock.cu",
        replaces="src/repro/kernels/token_clock.py:69",
        max_abs_err=worst, ms=ms, plain_ms=plain_ms,
        bound_ms=max(b_bytes, b_ops),
        bound_by="bytes" if b_bytes >= b_ops else "operations",
        library_ms=None, shape=[G, S], tolerance="bit-equal")


def phase_fused_flag_sets(trace):
    """The fused CUDA step against the plain version on the card: every flag
    set, same init state, same injected uniforms, every plane bit-equal (the
    histogram under the adjacent-bin rule).  The plain version grants
    through ``token_clock_update_ref``: it runs neither CUDA kernel."""
    worst, sets = 0.0, {}
    for name in sorted(cases.FLAG_SETS):
        case = cases.make_case(trace, cases.FLAG_SETS[name], 17,
                                   n_steps=192)
        plain = cases.run_plain(case, DEV)
        fused = cases.run_fused(case, DEV)
        blocks = cases.run_fused(case, DEV, block=64)
        torch.cuda.synchronize()
        ok, err, bad = cases.states_agree(plain, fused, case["has_lat"])
        ok2, err2, bad2 = cases.states_agree(fused, blocks, False)
        worst = max(worst, err, err2)
        sets[name] = bool(ok and ok2)
        if not (ok and ok2):
            fail(f"fused_steps disagrees with the plain version on flag set "
                 f"{name!r}: plane {bad if not ok else bad2}, max abs err "
                 f"{max(err, err2)}")
        if int(fused[1][:, 2].min()) <= 0:
            fail(f"flag set {name!r}: no op completed in the self-check")
    # a wider cell layout: more than one slot per lane, odd thread counts
    case = cases.make_case(trace, cases.FLAG_SETS["rio+bio-2ssd"], 23,
                               latencies=(0.5 * US, 2 * US, 9 * US),
                               candidates=(5, 40, 70), P=12, n_ops=60,
                               n_steps=256)
    ok, err, bad = cases.states_agree(
        cases.run_plain(case, DEV), cases.run_fused(case, DEV), False)
    sets["wide-T70-P12"] = bool(ok)
    if not ok:
        fail(f"fused_steps disagrees on the wide layout: plane {bad}, "
             f"max abs err {err}")
    return max(worst, err), sets


def scenario(n_lats, cands, **over):
    doc = json.loads(
        (ROOT / "examples" / "scenarios" / "hash_index_2ssd.json").read_text())
    lats = [float(x) for x in np.round(np.linspace(0.1, 10.0, n_lats), 4)]
    doc.update(latencies_us=lats, thread_candidates=list(cands), **over)
    return Scenario.from_dict(doc)


def phase_main_path():
    """The port's main path at real size: ``Experiment.run`` with the
    default options -- device cuda, every cell stepped by the fused kernel.
    The counts are set to 0 just before the run and read just after."""
    sc = scenario(N_LATS, CANDS)
    t0 = time.perf_counter()
    warm = Experiment(sc).run()                 # warm-up (trace + first use)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    art = Experiment(sc).run()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = {"fused_steps": sk.fused_steps.launches,
                "token_clock_update": tc.token_clock_update.launches}
    peak = torch.cuda.max_memory_allocated()
    if launches["fused_steps"] <= 0:
        fail("kernel fused_steps was not launched on the main path")
    if launches["token_clock_update"] != 0:
        fail("the main path launched the standalone token-clock kernel: the "
             "fused kernel is meant to inline the grant")

    # every cell counted its n_ops: sweep_grid raises otherwise; re-derive
    # the grid here for the step counts and a direct check
    tr = art.trace_result.trace
    cfg = sc.sim_config()
    t0 = time.perf_counter()
    grid = rt.sweep_grid(cfg, tr, sc.latencies_sec(), sc.thread_candidates,
                         n_ops=sc.n_ops)
    torch.cuda.synchronize()
    grid_wall_s = time.perf_counter() - t0
    thr = np.array([[dict(r.per_thread)[c] for c in CANDS] for r in art.rows])
    if not np.array_equal(thr, grid.throughput):
        fail("Experiment.run and sweep_grid disagree on the same grid")
    warm_thr = np.array([[dict(r.per_thread)[c] for c in CANDS]
                         for r in warm.rows])
    if not np.array_equal(thr, warm_thr):
        fail("two runs of the same scenario are not bit-identical")
    if not (np.isfinite(thr).all() and (thr > 0).all()
            and thr.shape == (N_LATS, len(CANDS))):
        fail("main path produced non-finite or misshapen throughputs")
    emit("main_path", scenario=sc.display_name, cells=int(thr.size),
         n_latencies=N_LATS, thread_candidates=list(CANDS), n_ops=sc.n_ops,
         trace_ops=int(tr.n_ops), trace_subops=int(tr.n_subops),
         cut="none", warmup_wall_s=warm_s, wall_s=wall_s,
         grid_wall_s=grid_wall_s, launches=launches,
         token_clock_note="0 by design: on this path the grant runs inside "
                          "sched_step.cu as the shared __device__ function; "
                          "the standalone kernel is driven by "
                          "plain_step_path",
         cell_steps_run=int(grid.cell_steps_run),
         cell_steps_bound=int(grid.cell_steps_bound),
         cell_steps_per_s=grid.cell_steps_run / grid_wall_s,
         peak_device_bytes=int(peak), all_cells_counted_n_ops=True,
         best_threads_first_last=[art.rows[0].n_threads,
                                  art.rows[-1].n_threads])
    return sc, art, launches


def phase_plain_step_path(art):
    """The port's other path on the card, in a counted window of its own:
    the same entry point with ``use_kernel=False`` steps the grid with the
    plain PyTorch body, which launches the standalone token-clock kernel
    once per step.  One cohort of the main path's grid at its full shape
    (all 128 latencies x 8 threads = 128 cells, the whole trace, n_ops
    uncut); the rows must be bit-identical to the fused kernel's."""
    cand = CANDS[0]
    sc_plain = scenario(N_LATS, (cand,))
    reset_counts()
    t0 = time.perf_counter()
    art_plain = Experiment(sc_plain, RunOptions(use_kernel=False)).run()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = {"fused_steps": sk.fused_steps.launches,
                "token_clock_update": tc.token_clock_update.launches}
    if launches["fused_steps"] != 0:
        fail("the plain-step path launched the fused kernel")
    if launches["token_clock_update"] <= 0:
        fail("kernel token_clock_update was not launched on the plain-step "
             "path")
    for a, b in zip(art_plain.rows, art.rows):
        got, want = dict(a.per_thread)[cand], dict(b.per_thread)[cand]
        if a.L_us != b.L_us or got != want:
            fail(f"plain-step path and fused kernel disagree at L={a.L_us}us, "
                 f"{cand} threads: {got} vs {want}")
    emit("plain_step_path", scenario=sc_plain.display_name,
         cells=len(art_plain.rows), n_latencies=N_LATS,
         thread_candidates=[cand], n_ops=sc_plain.n_ops,
         cut="threads (8) only: one of the main path's four cohorts",
         wall_s=wall_s, launches=launches,
         steps_per_cell=launches["token_clock_update"],
         bit_identical_to_fused_rows=True)
    return launches


def phase_agreement(sc, art):
    """A handful of main-path cells next to the host interpreter loop, and an
    open-loop run (Poisson arrivals at about half the closed-loop
    throughput, percentiles on) so the arrival and histogram planes run on
    the card too."""
    tr = art.trace_result.trace
    cfg = sc.sim_config()
    tol = rt.grid_tol(sc.n_ops)
    lats_s = sc.latencies_sec()
    cells = []
    worst = 0.0
    cands = list(sc.thread_candidates)
    n = len(lats_s)
    picks = [(0, 0), (n // 4, 1), (n // 2, 2), (3 * n // 4, 3), (n - 1, 3),
             (n - 1, 0)]
    for li, cj in picks:
        cand = cands[cj % len(cands)]
        got = dict(art.rows[li].per_thread)[cand]
        ref = simulate_compiled(
            replace(cfg, L_mem=lats_s[li], n_threads=cand), tr, sc.n_ops)
        rel = abs(got - ref.throughput) / ref.throughput
        worst = max(worst, rel)
        cells.append({"L_us": sc.latencies_us[li], "threads": cand,
                      "card": got, "host_loop": ref.throughput, "rel": rel})
    if worst >= tol:
        fail(f"card vs host loop: worst cell {worst:.4%} >= {tol:.4%}")

    # open loop: offered load = half the mid-latency closed-loop throughput
    rate = 0.5 * art.rows[len(art.rows) // 2].throughput
    sc_open = scenario(8, (16, 64), arrival={
        "kind": "poisson", "rate": rate, "seed": 3, "deadline": 0.002})
    art_open = Experiment(
        sc_open, RunOptions(collect_percentiles=True)).run()
    open_rows = []
    for row in art_open.rows:
        tail = row.tail
        vals = [tail["p50_us"], tail["p90_us"], tail["p99_us"],
                tail["max_us"]]
        if (tail["count"] + tail["missed"] != sc_open.n_ops
                or any(v is None or not math.isfinite(v) for v in vals)
                or not (vals[0] <= vals[1] <= vals[2] <= vals[3] * 1.02)):
            fail(f"open-loop tail is malformed at L={row.L_us}us: {tail}")
        if abs(row.throughput - rate) / rate > 0.15:
            fail(f"open-loop achieved load {row.throughput} is not the "
                 f"offered {rate} at L={row.L_us}us")
        open_rows.append({"L_us": row.L_us, "threads": row.n_threads,
                          "p50_us": vals[0], "p99_us": vals[2],
                          "missed": tail["missed"]})
    # one open-loop cell against the host loop's exact percentiles
    mid = art_open.rows[len(art_open.rows) // 2]
    spec = sc_open.arrival_spec()
    need = max(c + 2 * c + sc_open.n_ops
               for c in sc_open.thread_candidates) + 1
    ref = simulate_compiled(
        replace(cfg, L_mem=mid.L_us * US, n_threads=mid.n_threads), tr,
        sc_open.n_ops, arrivals=generate_arrivals(spec, need),
        collect_percentiles=True, deadline=spec.deadline)
    rs = ref.latency_summary
    rel50 = abs(mid.tail["p50_us"] * US - rs.p50) / rs.p50
    rel99 = abs(mid.tail["p99_us"] * US - rs.p99) / rs.p99
    if rel50 > 0.10 or rel99 > 0.25:
        fail(f"open-loop percentiles off the host loop: p50 {rel50:.3f}, "
             f"p99 {rel99:.3f}")
    emit("agreement", tolerance=tol, worst_rel=worst, cells=cells,
         open_loop={"offered_ops_per_s": rate, "rows": open_rows,
                    "p50_rel_vs_host_loop": rel50,
                    "p99_rel_vs_host_loop": rel99,
                    "p50_tol": 0.10, "p99_tol": 0.25})


def gathered_rows(c, ci_before, ci_after):
    """``(kd_rows, se_rows)``: the distinct rows of the trace tables that one
    launch can have read, from the cells' cursors before and after it.  A
    cell reads ``se`` at every cursor position it passes, and ``kd`` for the
    suboperations of the ops its threads held at the start or fetched."""
    n = c.n_trace
    se = c.se[:n].cpu().numpy()
    ops_len = (se[:, 1] - se[:, 0]).astype(np.int64)
    held = (c.nthr_g.cpu().numpy().astype(np.int64)
            * c.substep.flags["n_cores"])
    kd_ops = np.zeros(n, bool)
    se_ops = np.zeros(n, bool)
    for g in range(c.G):
        cur = int(ci_before[g, 0])
        adv = int(ci_after[g, 2]) - int(ci_before[g, 2])
        se_ops[np.arange(cur, cur + adv + 1) % n] = True
        kd_ops[np.arange(cur - held[g], cur + adv + 1) % n] = True
    return int(ops_len[kd_ops].sum()), int(se_ops.sum())


def phase_timing(sc, art, sm_mhz):
    """Per-launch time of ``fused_steps`` at the main path's shapes (one
    cohort = 128 cells; K = 1024 steps), the plain version's time for the
    same K steps from the same state, and the kernel's bounds."""
    tr = art.trace_result.trace
    cohorts = rt.plan_grid(sc.sim_config(), tr, sc.latencies_sec(),
                           sc.thread_candidates, n_ops=sc.n_ops, device=DEV)
    reps = 8
    rows = []
    for c in cohorts:
        tail = c.fused_tail()
        us = [c.uniforms(ck) for ck in range(4)]
        state0 = tuple(p.clone() for p in c.state)
        warmed = sk.fused_steps(c.substep, state0, us[0], *tail)  # warm-up
        holder = {"s": tuple(p.clone() for p in warmed), "i": 0}

        def launch():
            holder["i"] += 1
            holder["s"] = sk.fused_steps(
                c.substep, holder["s"], us[holder["i"] % 4], *tail,
                inplace=True)

        ms = cuda_ms(launch, reps)
        # the same launches again, untimed, for the table rows they read
        holder = {"s": warmed, "i": 0}
        kd_rows = se_rows = 0
        for _ in range(reps):
            before = holder["s"][1].cpu().numpy()
            launch()
            kd_n, se_n = gathered_rows(c, before,
                                       holder["s"][1].cpu().numpy())
            kd_rows += kd_n
            se_rows += se_n
        kd_rows, se_rows = kd_rows / reps, se_rows / reps
        K = us[0].shape[0]
        # bytes one launch must move: state in and out, the uniform block,
        # the per-cell vectors (L_mem f64, nthr i32, warm i32), and the
        # table rows it gathers (two f64 a row), each counted once
        nbytes = (2 * state_bytes(c.state) + us[0].numel() * 8
                  + c.G * 16 + (kd_rows + se_rows) * 16)
        T = c.state[2].shape[1]
        P = c.state[5].shape[-1]
        # f64 operations of one step of one cell: two ops per ring slot and
        # per window slot (key select + min), ~64 scalar ops
        flops = K * c.G * (2 * T + 2 * P + 64)
        b_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        b_ops = flops / F64_FLOP_PER_S * 1e3
        rows.append({"T_max": c.T_max, "G": c.G, "K": K, "n_u": c.n_u,
                     "ms": ms, "us_per_step": ms * 1e3 / K,
                     "bound_bytes_ms": b_bytes, "bound_ops_ms": b_ops,
                     "serial_chain_ms": K * CHAIN_CYCLES / (sm_mhz * 1e3),
                     "state_bytes": state_bytes(c.state),
                     "u_block_bytes": us[0].numel() * 8,
                     "kd_rows_gathered": kd_rows, "se_rows_gathered": se_rows,
                     "kd_rows_total": int(c.kd.shape[0]),
                     "se_rows_total": int(c.se.shape[0])})
    # plain version: the widest cohort, the same K steps from the init
    # state, granting through the plain token clock (no CUDA kernel in it)
    c = cohorts[-1]
    u0 = c.uniforms(0)
    sub = sk.make_substep(**c.substep.flags,
                          token_clock=tc.token_clock_update_ref)

    def plain_k():
        s = c.state
        for k in range(u0.shape[0]):
            s = sub(s, u0[k], c.kd, c.se, c.arr, c.nthr_g, c.n_trace,
                    c.L_mem_g, c.warm_g, c.n_ops, c.dyn)
        return s

    before = tc.token_clock_update.launches
    s_plain = plain_k()                          # warm-up + comparison
    plain_ms = cuda_ms(plain_k, 1)
    if tc.token_clock_update.launches != before:
        fail("the plain version used for the comparison launched the "
             "token-clock kernel")
    s_kern = sk.fused_steps(c.substep, c.state, u0, *c.fused_tail())
    torch.cuda.synchronize()
    ok, err, bad = cases.states_agree(s_plain, s_kern, False)
    if not ok:
        fail(f"fused_steps disagrees with the plain version at the main "
             f"path's shape after {u0.shape[0]} steps: plane {bad}, max "
             f"abs err {err}")
    steps_per_s = sum(r["G"] * r["K"] for r in rows) / sum(
        r["ms"] * 1e-3 for r in rows)
    emit("timing", fused_steps=rows, plain_ms_widest_cohort=plain_ms,
         kernel_cell_steps_per_s=steps_per_s,
         serial_chain_model=dict(CHAIN, cycles_per_step=CHAIN_CYCLES,
                                 sm_clock_mhz=sm_mhz,
                                 note="assumed latencies, not measured"),
         note="the bytes and operations bounds are both about a "
              "microsecond; the binding limit is neither but the serial "
              "chain: K dependent steps per cell (serial_chain_ms is a "
              "modelled floor of it, us_per_step what a step takes)")
    widest = rows[-1]
    return widest, plain_ms, err, (c.G, c.state[6].shape[1]
                                   if len(c.state) > 6 else 1)


def main():
    t_all = time.perf_counter()
    torch.cuda.set_device(0)
    card, sm_mhz = phase_card()
    phase_build()

    sc_small = scenario(2, (8,), n_keys=2000, n_wl_ops=600)
    store, wl = Experiment(sc_small).build()
    small_trace = run_trace(store, wl, warmup_frac=sc_small.warmup_frac).trace
    err_fused, sets = phase_fused_flag_sets(small_trace)
    emit("kernel_checks", fused_steps_flag_sets=sets,
         fused_steps_max_abs_err=err_fused,
         tolerance="every plane bit-equal; histogram: equal, or unit mass "
                   "moved between adjacent bins, same row total")

    sc, art, launches = phase_main_path()
    plain_launches = phase_plain_step_path(art)
    phase_agreement(sc, art)
    widest, plain_ms, err_main, (G, S) = phase_timing(sc, art, sm_mhz)
    tok = phase_token_clock(G, S)
    tok["launches"] = plain_launches["token_clock_update"]
    tok["path"] = "plain_step_path"
    tok["launches_main_path"] = launches["token_clock_update"]
    fused = dict(
        name="sched_step.fused_steps", route="cuda",
        source="src/repro_torch/kernels/csrc/sched_step.cu",
        replaces="src/repro/kernels/sched_step.py:622",
        launches=launches["fused_steps"], path="main_path",
        max_abs_err=max(err_fused, err_main), ms=widest["ms"],
        plain_ms=plain_ms,
        bound_ms=max(widest["bound_bytes_ms"], widest["bound_ops_ms"]),
        bound_by=("bytes" if widest["bound_bytes_ms"]
                  >= widest["bound_ops_ms"] else "operations"),
        bound_bytes_ms=widest["bound_bytes_ms"],
        bound_ops_ms=widest["bound_ops_ms"],
        serial_chain_ms=widest["serial_chain_ms"],
        binding="the serial chain (latency of K dependent steps), which "
                "neither the bytes nor the operations bound describes",
        library_ms=None,
        shape={"G": widest["G"], "T": widest["T_max"], "K": widest["K"]},
        tolerance="bit-equal (histogram: adjacent-bin rule)")
    print(json.dumps({"kernels": [fused, tok]}), flush=True)
    print(card, flush=True)
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke_phases.json").write_text(
        json.dumps({"card": card, "phases": PHASES,
                    "kernels": [fused, tok],
                    "total_s": time.perf_counter() - t_all}, indent=1))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
