#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``repro_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py [--seed N]

It builds the CUDA kernels from ``src/repro_torch/kernels/csrc/`` with
``nvcc``, holds each kernel against its plain PyTorch version on the card,
and drives the port's paths, each in a counted window of its own:

  * the grid replay -- one ``Scenario`` through ``Experiment.run`` with every
    scalar-latency grid cell stepped by the fused CUDA kernel -- at real
    size, checked against the host interpreter loop;
  * the plain-step path (which launches the standalone token-clock kernel)
    on one cohort of the same grid;
  * serving: ``ServeEngine`` with qwen2.5-3b at full width (weights drawn on
    the card from ``--seed``) answering 8 requests, every decode step's
    attention through the paged CUDA kernel, two of the requests checked
    against the dense decode path teacher-forced on the served tokens.

It times the kernels and prints one JSON object per phase.  The last line is
``{"ok": true, "device": {...}}``.  Any failing phase exits non-zero; there
is no CPU fallback: without a CUDA device the script fails.
"""
import argparse
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

import torch.nn.functional as F

from repro_torch.configs import ARCHS
from repro_torch.core.engines import run_trace
from repro_torch.core.experiment import Experiment, RunOptions, Scenario
from repro_torch.core.sim import generate_arrivals, simulate_compiled
from repro_torch.core.sim import replay_torch as rt
from repro_torch.kernels import _build
from repro_torch.kernels import paged_kv_gather as pk
from repro_torch.kernels import sched_step as sk
from repro_torch.kernels import token_clock as tc
from repro_torch.kernels.ref import paged_decode_attention_ref
from repro_torch.models import transformer as tf
from repro_torch.serve.engine import Request, ServeEngine

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
# ... and the dense rates for the paged kernel's input types: bfloat16 on
# the tensor cores, float32 outside them.
PEAK_FLOP_PER_S = {"bfloat16": 989e12, "float32": 67e12}

# Serving: qwen2.5-3b at full width (36 layers, d 2048, 16/2 heads of 128,
# d_ff 11008, vocab 151 936, tied embeddings, bfloat16), nothing cut.
SERVE_ARCH = "qwen2.5-3b"
SERVE = dict(n_pages=1024, page_size=16, max_slots=8)
N_REQUESTS = 8
PROMPT_LEN = (100, 1000)         # drawn uniformly from the seed, inclusive
N_NEW = 32
# Paged vs dense decode, teacher-forced on the served tokens: max abs logit
# difference per step, and the argmax rule (the two must agree wherever the
# dense path's top-1 minus top-2 margin exceeds this).  The two paths run the
# same bfloat16 model through different kernels: the paged attention kernel
# against the plain float32 decode attention, and matrix products of batch
# 8 against batch 1, which cuBLAS may sum in another order.  Each rounds its
# bfloat16 results (8-bit significand) to a neighbouring value now and then,
# and the differences travel through 36 layers.  Logits here are of order
# 1-5, where a bfloat16 step is 0.0078-0.031; 0.25 is eight steps at the top
# of that range.
LOGIT_TOL = 0.25
# Ring depths (n_buffers) the paged kernel is timed at; the engine, like the
# reference, runs it at 2.
DEPTHS = (2, 4, 8)

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
    pk.paged_decode_attention.launches = 0


def counts():
    return {"fused_steps": sk.fused_steps.launches,
            "token_clock_update": tc.token_clock_update.launches,
            "paged_decode_attention": pk.paged_decode_attention.launches}


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
    launches = counts()
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
    launches = counts()
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


# -- paged decode attention and the serving path -------------------------------


def phase_paged_checks():
    """The paged attention kernel against its plain version on the card:
    the reference's five ``PAGED_CASES`` x n_buffers 2, 3, 4, the length-1 /
    exactly-full edge case and the serving shape, each within the
    reference's own tolerance (3e-2 bfloat16, 5e-5 float32)."""
    checks, worst = [], {"bfloat16": 0.0, "float32": 0.0}
    named = [(f"paged-{i}", c) for i, c in enumerate(cases.PAGED_CASES)]
    named += [("edge-len1-full", cases.PAGED_EDGE),
              ("serve-shape", cases.PAGED_SERVE)]
    for name, case in named:
        c = cases.make_paged_case(case, seed=1)
        args = cases.paged_tensors(c, DEV)
        want = paged_decode_attention_ref(*args)
        for nb in (2, 3, 4):
            got = pk.paged_decode_attention(*args, n_buffers=nb)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            tol = cases.PAGED_TOL[c["dtype"]]
            checks.append({"case": name, "n_buffers": nb,
                           "dtype": c["dtype"], "max_abs_err": err,
                           "tol": tol})
            worst[c["dtype"]] = max(worst[c["dtype"]], err)
            if not err <= tol:
                fail(f"paged_decode_attention disagrees with its plain "
                     f"version on {name}, n_buffers {nb}: max abs err {err} "
                     f"> {tol}")
    emit("paged_checks", n_checks=len(checks), max_abs_err_by_dtype=worst,
         checks=checks)
    return worst


def phase_serve_path(seed):
    """The port's serving path at full width: qwen2.5-3b through
    ``ServeEngine`` on the card, 8 requests of 100-1000 prompt tokens, 32
    new tokens each.  A one-request warm-up first; then the counts are set
    to 0, the requests are served, and the counts are read."""
    cfg = ARCHS[SERVE_ARCH]
    t0 = time.perf_counter()
    eng = ServeEngine(cfg, seed=seed, device=DEV, **SERVE)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(eng.params))
    rng = np.random.default_rng(seed)
    eng.submit(Request(rid=-1, prompt=rng.integers(1, cfg.vocab, 64)
                       .astype(np.int32), max_new_tokens=3))
    eng.run()                                          # warm-up
    lens = rng.integers(PROMPT_LEN[0], PROMPT_LEN[1] + 1, N_REQUESTS)
    reqs = [Request(rid=i, prompt=rng.integers(1, cfg.vocab, int(n))
                    .astype(np.int32), max_new_tokens=N_NEW)
            for i, n in enumerate(lens)]
    picks = (int(np.argmin(lens)), int(np.argmax(lens)))
    logs = {rid: [] for rid in picks}
    before = dict(eng.stats)

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    finished = []
    while (eng.waiting or eng.active) and eng.steps < 10 * N_NEW:
        finished.extend(eng.step())
        seq_ids, logits = eng.last_decode
        for rid in picks:
            if rid in seq_ids:
                logs[rid].append(logits[seq_ids.index(rid)].float().clone())
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = counts()
    peak = torch.cuda.max_memory_allocated()
    st = {k: eng.stats[k] - before[k] for k in eng.stats}

    if len(finished) != N_REQUESTS or any(
            len(r.out_tokens) != N_NEW for r in reqs):
        fail(f"serving returned {len(finished)} requests with "
             f"{[len(r.out_tokens) for r in reqs]} tokens; expected "
             f"{N_REQUESTS} x {N_NEW}")
    if any(not 0 <= t < cfg.vocab for r in reqs for t in r.out_tokens):
        fail("serving produced a token id outside the vocabulary")
    if len(eng.cache.free) != SERVE["n_pages"] or eng.cache.tables:
        fail(f"pages not released: {len(eng.cache.free)} of "
             f"{SERVE['n_pages']} free")
    if launches["paged_decode_attention"] != cfg.n_layers * st["decode_steps"]:
        fail(f"paged_decode_attention launched "
             f"{launches['paged_decode_attention']} times for "
             f"{st['decode_steps']} decode steps of {cfg.n_layers} layers")
    if launches["fused_steps"] or launches["token_clock_update"]:
        fail(f"the serving path launched a scheduler kernel: {launches}")
    prof = profile_decode(eng, rng)
    emit("serve_path", arch=cfg.name, n_layers=cfg.n_layers,
         d_model=cfg.d_model, heads=[cfg.n_heads, cfg.n_kv_heads],
         head_dim=cfg.head_dim, d_ff=cfg.d_ff, vocab=cfg.vocab,
         params=n_params, param_bytes=2 * n_params, cut="none",
         weights=f"random, drawn on the card from seed {seed}",
         init_s=init_s, **SERVE, requests=len(finished),
         prompt_lens=[int(n) for n in lens],
         prompt_tokens=st["prefill_tokens"],
         generated_tokens=sum(len(r.out_tokens) for r in reqs),
         prefill_s=st["prefill_s"],
         prefill_tokens_per_s=st["prefill_tokens"] / st["prefill_s"],
         decode_s=st["decode_s"], decode_steps=st["decode_steps"],
         decode_tokens=st["decode_tokens"],
         decode_tokens_per_s=st["decode_tokens"] / st["decode_s"],
         decode_ms_per_step=1e3 * st["decode_s"] / st["decode_steps"],
         wall_s=wall_s, launches=launches,
         launches_per_decode_step=(launches["paged_decode_attention"]
                                   / st["decode_steps"]),
         peak_device_bytes=int(peak), pages_released=True,
         decode_profile=prof)
    return eng, reqs, logs, picks, launches


def profile_decode(eng, rng, steps=3):
    """Where a decode step's time goes: ``torch.profiler`` over ``steps``
    decode-only steps of a fresh batch of 8 requests (after the counted
    window).  Device busy time is the sum of the kernels' own device time;
    the rest of the host wall is the device waiting for the host."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    cfg = eng.cfg
    for i in range(N_REQUESTS):
        n = int(rng.integers(PROMPT_LEN[0], PROMPT_LEN[1] + 1))
        eng.submit(Request(rid=1000 + i, prompt=rng.integers(
            1, cfg.vocab, n).astype(np.int32), max_new_tokens=steps + 2))
    eng.step()                          # admission (prefill) + first decode
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    eng.run()
    per_kernel = {}
    for ev in prof.key_averages():
        # device-side events only (kernels, copies): an operator's own
        # device time repeats that of the kernels it launched
        if getattr(ev, "device_type", None) != DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total", 0.0)
        if dev_us > 0:
            per_kernel[ev.key] = per_kernel.get(ev.key, 0.0) + dev_us / 1e3
    busy_ms = sum(per_kernel.values())
    paged_ms = sum(v for k, v in per_kernel.items() if "paged_decode" in k)
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:8]
    return {"steps": steps, "wall_ms_per_step": wall_ms / steps,
            "device_busy_ms_per_step": busy_ms / steps,
            "device_idle_share": (1 - busy_ms / wall_ms) if busy_ms else None,
            "paged_kernel_ms_per_step": paged_ms / steps,
            "top_device_ms_per_step": {k[:80]: v / steps for k, v in top},
            "note": None if busy_ms else "the profiler saw no device time"}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def phase_serve_dense_check(eng, reqs, logs, picks):
    """Two served requests (the shortest and the longest prompt) through the
    port's dense path -- ``prefill`` + ``decode_step`` -- teacher-forced on
    the tokens the paged path produced.  Per decode step: max abs logit
    difference against the paged path's logits (<= ``LOGIT_TOL``), and the
    argmax rule.  The counts are not reset: nothing here launches the paged
    kernel."""
    cfg = eng.cfg
    before = pk.paged_decode_attention.launches
    out = []
    for rid in picks:
        req = reqs[rid]
        S = len(req.prompt)
        prompt = torch.as_tensor(req.prompt, device=DEV)[None]
        logits, cache = tf.prefill(eng.params, prompt, cfg,
                                   max_len=S + N_NEW)
        first_same = int(torch.argmax(logits[0, -1])) == req.out_tokens[0]
        diffs, margins, agree = [], [], []
        for t, paged in enumerate(logs[rid]):
            tok = torch.tensor([[req.out_tokens[t]]], device=DEV)
            dense, cache = tf.decode_step(eng.params, cache, tok, cfg)
            d = dense[0, 0].float()
            top2 = torch.topk(d, 2).values
            margin = float(top2[0] - top2[1])
            same = int(torch.argmax(d)) == int(torch.argmax(paged))
            diffs.append(float((d - paged).abs().max()))
            margins.append(margin)
            agree.append(same)
            if not same and margin > LOGIT_TOL:
                fail(f"request {rid}, decode step {t}: paged and dense argmax "
                     f"differ with a dense top-2 margin of {margin} > "
                     f"{LOGIT_TOL}")
        if max(diffs) > LOGIT_TOL:
            fail(f"request {rid}: paged vs dense logits differ by "
                 f"{max(diffs)} > {LOGIT_TOL}")
        if not first_same:
            fail(f"request {rid}: the dense prefill's first token differs")
        out.append({"rid": rid, "prompt_len": S, "steps": len(diffs),
                    "max_abs_logit_diff_per_step": diffs,
                    "argmax_agree_per_step": agree,
                    "argmax_agreement": sum(agree) / len(agree),
                    "dense_top2_margin_per_step": margins,
                    "first_token_same": first_same})
    if pk.paged_decode_attention.launches != before:
        fail("the dense path launched the paged kernel")
    emit("serve_dense_check", tolerance=LOGIT_TOL,
         argmax_rule="argmax must agree where the dense top-1 minus top-2 "
                     "margin exceeds the tolerance",
         requests=out,
         max_abs_logit_diff=max(max(r["max_abs_logit_diff_per_step"])
                                for r in out))


def paged_bound(c):
    """(bound_ms, bound_by, bytes, flops): the least time the card could
    take for this call.  Bytes: the valid K/V rows of every (sequence, KV
    head) once, q in, the output out, the block-table entries used and the
    lengths.  Operations: q.k and p.v, 2 x 2 x D per (query head, position),
    at the peak rate of the inputs' type."""
    B, Hq, D = c["q"].shape
    page, Hkv = c["k_pages"].shape[1], c["k_pages"].shape[2]
    elem = 2 if c["dtype"] == "bfloat16" else 4
    L = c["lengths"].astype(np.int64)
    n_pages = -(-L // page)
    nbytes = (2 * int(L.sum()) * Hkv * D * elem + 2 * B * Hq * D * elem
              + 4 * int(n_pages.sum()) + 4 * B)
    flops = 4 * Hq * D * int(L.sum())
    b_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    b_ops = flops / PEAK_FLOP_PER_S[c["dtype"]] * 1e3
    return (max(b_bytes, b_ops), "bytes" if b_bytes >= b_ops
            else "operations", nbytes, flops)


def paged_composition(q, k_pages, v_pages, bt, lengths):
    """A two-call PyTorch composition of the same function (gather the
    pages, then ``scaled_dot_product_attention`` with grouped heads and a
    length mask): the yardstick beside the kernel, used nowhere in the
    port.  No single PyTorch call computes a paged attention."""
    B, Hq, D = q.shape
    page, Hkv = k_pages.shape[1], k_pages.shape[2]
    S = bt.shape[1] * page
    k = k_pages[bt.long()].reshape(B, S, Hkv, D).transpose(1, 2)
    v = v_pages[bt.long()].reshape(B, S, Hkv, D).transpose(1, 2)
    mask = (torch.arange(S, device=q.device)[None, :]
            < lengths[:, None])[:, None, None, :]
    return F.scaled_dot_product_attention(
        q[:, :, None], k, v, attn_mask=mask, enable_gqa=True)[:, :, 0]


def phase_paged_timing():
    """The kernel, its plain version and the two-call composition by CUDA
    events after a warm-up, at the serving shape and at a 32k context; the
    kernel also at ring depths ``DEPTHS``."""
    rows = []
    for name, case, reps in (("serve", cases.PAGED_SERVE, 50),
                             ("long-32k", cases.PAGED_LONG, 10)):
        c = cases.make_paged_case(case, seed=5)
        args = cases.paged_tensors(c, DEV)
        want = paged_decode_attention_ref(*args)
        got = pk.paged_decode_attention(*args)
        comp = paged_composition(*args)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        comp_err = float((comp.float() - want.float()).abs().max())
        tol = cases.PAGED_TOL[c["dtype"]]
        if not err <= tol:
            fail(f"paged_decode_attention at the {name} shape: max abs err "
                 f"{err} > {tol}")
        ms = cuda_ms(lambda: pk.paged_decode_attention(*args), reps)
        # the prefetch depth P of the paper's model: the ring's slots
        ms_by_depth = {nb: cuda_ms(lambda nb=nb: pk.paged_decode_attention(
            *args, n_buffers=nb), reps) for nb in DEPTHS}
        plain_ms = cuda_ms(lambda: paged_decode_attention_ref(*args),
                           max(2, reps // 5))
        comp_ms = cuda_ms(lambda: paged_composition(*args), reps)
        bound_ms, bound_by, nbytes, flops = paged_bound(c)
        B, Hq, D = c["q"].shape
        rows.append({"shape": name, "B": B, "Hq": Hq,
                     "Hkv": c["k_pages"].shape[2], "D": D,
                     "page": c["k_pages"].shape[1],
                     "ppseq": c["block_tables"].shape[1],
                     "dtype": c["dtype"], "tokens": int(c["lengths"].sum()),
                     "max_len": int(c["lengths"].max()), "ms": ms,
                     "ms_by_n_buffers": ms_by_depth,
                     "plain_ms": plain_ms, "composition_ms": comp_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "bytes": nbytes, "flops": flops,
                     "roofline_share": bound_ms / ms,
                     "achieved_bytes_per_s": nbytes / (ms * 1e-3),
                     "max_abs_err": err, "composition_max_abs_err": comp_err})
        del args, want, got, comp
        torch.cuda.empty_cache()
    emit("paged_timing", rows=rows,
         composition="k_pages[block_tables] gather + "
                     "F.scaled_dot_product_attention(enable_gqa=True, "
                     "attn_mask=length mask): two calls, timed together")
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the served model's weights and prompts")
    args = ap.parse_args()
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
    paged_err = phase_paged_checks()

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

    eng, reqs, logs, picks, serve_launches = phase_serve_path(args.seed)
    phase_serve_dense_check(eng, reqs, logs, picks)
    del eng, logs
    torch.cuda.empty_cache()
    serve_row, long_row = phase_paged_timing()
    paged = dict(
        name="paged_kv_gather.paged_decode_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/paged_kv_gather.cu",
        replaces="src/repro/kernels/paged_kv_gather.py:124",
        launches=serve_launches["paged_decode_attention"], path="serve_path",
        max_abs_err=max(paged_err.values()),
        max_abs_err_by_dtype=paged_err, ms=serve_row["ms"],
        plain_ms=serve_row["plain_ms"], bound_ms=serve_row["bound_ms"],
        bound_by=serve_row["bound_by"], library_ms=None,
        composition_ms=serve_row["composition_ms"],
        composition="two calls, no single PyTorch call computes it: "
                    "k_pages[block_tables] + scaled_dot_product_attention",
        shape={k: serve_row[k] for k in ("B", "Hq", "Hkv", "D", "page",
                                         "ppseq", "dtype", "tokens")},
        long_context={k: long_row[k] for k in (
            "B", "ppseq", "tokens", "ms", "plain_ms", "composition_ms",
            "bound_ms", "bound_by")},
        tolerance="3e-2 bfloat16, 5e-5 float32 (absolute)")
    kernels = [fused, tok, paged]
    total_s = time.perf_counter() - t_all
    emit("total", seconds=total_s)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke_phases.json").write_text(
        json.dumps({"card": card, "phases": PHASES, "kernels": kernels,
                    "total_s": total_s}, indent=1))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
