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
    against the dense decode path teacher-forced on the served tokens;
  * the kernel-ops entry point: ``benchmarks.kernels_bench_torch`` runs
    flash attention, paged decode attention and wkv6 through
    ``repro_torch.kernels.ops`` at the reference bench's full-width shapes
    (llava-next-mistral-7b's attention heads, rwkv6-3b's WKV heads).

It times the kernels and prints one JSON object per phase.  The last line is
``{"ok": true, "device": {...}}``.  Any failing phase exits non-zero; there
is no CPU fallback: without a CUDA device the script fails.
"""
import argparse
import json
import math
import re
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
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import paged_kv_gather as pk
from repro_torch.kernels import sched_step as sk
from repro_torch.kernels import token_clock as tc
from repro_torch.kernels import wkv6 as wk
from repro_torch.kernels.ref import (flash_attention_ref,
                                     paged_decode_attention_ref, wkv6_ref)
from repro_torch.models import layers
from repro_torch.models import transformer as tf
from repro_torch.serve.engine import Request, ServeEngine

from benchmarks import kernels_bench_torch as kbench
from benchmarks import sched_split_torch as ssplit
from benchmarks.kernels_bench_torch import card_state, cuda_ms

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
# reference, runs it at 2.  mma_bf16 holds its ring in whole 64-row rounds
# (kernels.paged_kv_gather.ring_rounds), so at 16-token pages depths 2-4 are
# one ring of 2 rounds, 8 is 3 and 16 is 5; each row records the ring of
# each depth beside its time.
DEPTHS = (2, 4, 8, 16)
# Sequences of the kernel bench's paged shape held against the plain version
# at a time: its gather, 4x head repeat and float32 copy take about 10 GB for
# 8 sequences beside the 17.2 GB store (about 70 GB for all 128 at once).
PAGED_BENCH_CHUNK = 8
# Flash against its plain version and, at the bench shapes, the blockwise
# twin: also the largest error of one query row relative to the row,
# ||got - want|| / ||want|| over its D values, within FLASH_ROW_TOL (1e-2;
# the reason is in tests/_torch_kernel_cases.py).  The absolute 3e-2 alone is
# about the size of a typical output at long S (|out| ~ sqrt(e/n) for n
# visible keys: 0.04 at S 4096, 0.015 at S 32768), so it would pass a fault
# on the far KV tiles that is wrong by tens of percent.
FLASH_ROW_TOL = cases.FLASH_ROW_TOL
# The paged kernel against its plain version: beside PAGED_TOL, the largest
# error of one (b, query head) row relative to the row, within PAGED_ROW_TOL
# (1e-2; the reason is in tests/_torch_kernel_cases.py).  Typical outputs at
# 32k keys are about 0.009, a third of the absolute 3e-2.
PAGED_ROW_TOL = cases.PAGED_ROW_TOL

OUT_DIR = ROOT / "chiprun_out"
PHASES = []


def emit(name, **fields):
    line = {"phase": name, **fields}
    PHASES.append(line)
    print(json.dumps(line), flush=True)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


KERNELS = {"fused_steps": sk.fused_steps,
           "token_clock_update": tc.token_clock_update,
           "paged_decode_attention": pk.paged_decode_attention,
           "flash_attention": fa.flash_attention,
           "wkv6": wk.wkv6}


def reset_counts():
    for fn in KERNELS.values():
        fn.launches = 0
    fa.flash_attention.launches_by_instance = dict.fromkeys(fa.INSTANCES, 0)
    pk.paged_decode_attention.launches_by_instance = dict.fromkeys(
        pk.INSTANCES, 0)
    wk.wkv6.launches_by_instance = dict.fromkeys(wk.INSTANCES, 0)


def counts():
    return {name: fn.launches for name, fn in KERNELS.items()}


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
    flash = lib_ptxas(info["log"], "flash_attention", _flash_func)
    for key, e in flash.items():
        inst, D = key.split("/D")
        e["smem_bytes"] = fa.smem_bytes(int(D), inst)
    hgmma = sass_count("flash_attention", _flash_func, "HGMMA")
    paged = lib_ptxas(info["log"], "paged_kv_gather", _paged_func)
    hmma = sass_count("paged_kv_gather", _paged_func, "HMMA")
    sched = lib_ptxas(info["log"], "sched_step", _sched_func)
    sched_sass = {op: sass_count("sched_step", _sched_func, op)
                  for op in ("REDUX", "SHFL")}
    wkv = lib_ptxas(info["log"], "wkv6", _wkv_func)
    wkv_sass = {op: sass_count("wkv6", _wkv_func, op)
                for op in ("HMMA", "MUFU")}
    emit("build", seconds=round(info["seconds"], 3), built=info["built"],
         nvcc_flags=info["flags"], dir=str(_build.build_dir().relative_to(ROOT)),
         ptxas=regs[:12], flash_ptxas=flash, flash_hgmma=hgmma,
         paged_ptxas=paged, paged_hmma=hmma, sched_ptxas=sched,
         sched_sass=sched_sass, wkv_ptxas=wkv, wkv_sass=wkv_sass)
    tc_keys = sorted(k for k in WKV_FUNCS.values()
                     if k.startswith("chunk_tc_bf16"))
    if "wkv6" in info["built"] and sorted(
            k for k in wkv if k.startswith("chunk_tc_bf16")) != tc_keys:
        fail(f"ptxas reported no lines for some wkv6 chunk_tc_bf16 kernels: "
             f"{sorted(wkv)}")
    if any(not e.get("spills", "").startswith(
            "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads")
           for k, e in wkv.items() if k.startswith("chunk_tc_bf16")):
        fail(f"a wkv6 chunk_tc_bf16 kernel spills: {wkv}")
    if wkv_sass["HMMA"] is not None and not all(
            wkv_sass["HMMA"].get(k, 0) > 0 for k in tc_keys):
        fail(f"a wkv6 chunk_tc_bf16 kernel has no HMMA instruction: "
             f"{wkv_sass}")
    if hmma is not None and not all(
            n > 0 for k, n in hmma.items() if k.startswith("mma_bf16")):
        fail(f"a paged mma_bf16 kernel has no HMMA instruction: {hmma}")
    if any("spills" in e and not e["spills"].startswith(
            "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads")
           and k.startswith("mma_bf16") for k, e in paged.items()):
        fail(f"a paged mma_bf16 kernel spills: {paged}")
    return flash, hgmma, paged, hmma, sched, sched_sass, wkv, wkv_sass


#: mangled kernel name -> key ("instance/D<head_dim>") of the flash library
FLASH_FUNCS = {**{f"_Z19flash_fwd_tc_kernelILi{D}E": f"wgmma_bf16/D{D}"
                  for D in fa.HEAD_DIMS},
               **{f"_Z16flash_fwd_kernelIfLi{D}E": f"scalar_f32/D{D}"
                  for D in fa.HEAD_DIMS}}
#: ... and of the paged library (scalar_f32 takes any head_dim)
PAGED_FUNCS = {**{f"_Z22paged_decode_tc_kernelILi{D}E": f"mma_bf16/D{D}"
                  for D in pk.TC_HEAD_DIMS},
               "_Z19paged_decode_kernelP": "scalar_f32"}


def _prefix_key(table):
    def key(name):
        for prefix, k in table.items():
            if name.startswith(prefix):
                return k
        return None
    return key


#: ... and of the wkv6 library, by instance, head_dim and log_w's type
WKV_FUNCS = {**{f"_Z14wkv6_tc_kernelILi{D}E{m}": f"chunk_tc_bf16/D{D}/{w}"
                for D in wk.TC_HEAD_DIMS
                for m, w in (("f", "log_w f32"),
                             ("13__nv_bfloat16", "log_w bf16"))},
             "_Z11wkv6_kernelIffE": "scalar_f32/log_w f32",
             "_Z11wkv6_kernelIf13__nv_bfloat16E": "scalar_f32/log_w bf16"}

_flash_func = _prefix_key(FLASH_FUNCS)
_paged_func = _prefix_key(PAGED_FUNCS)
_wkv_func = _prefix_key(WKV_FUNCS)


def _sched_func(name):
    """The scheduler library's two kernels: the normal and the profiling
    instance of ``sched_step_kernel<PROF>``."""
    if "sched_step_kernel" not in name:
        return None
    return "profiling" if "ILb1E" in name else "normal"


def lib_ptxas(log, lib, func_key):
    """``-Xptxas -v`` of one library, per kernel (``func_key`` maps a
    mangled name to its key): its line (registers, barriers) and spills.
    The dynamic shared memory the wrapper opts into is not in it (ptxas
    does not see it)."""
    out, key = {}, None
    in_lib = False
    for ln in log.splitlines():
        if ln.startswith("["):
            in_lib = ln.startswith(f"[{lib}]")
        if not in_lib:
            continue
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            key = func_key(m.group(1))
            continue
        if key is None:
            continue
        e = out.setdefault(key, {})
        if "spill stores" in ln:
            e["spills"] = ln.strip()
        elif "Used" in ln and "registers" in ln:
            e["ptxas"] = ln.split(":", 1)[1].strip()
    return out


def sass_count(lib, func_key, opcode):
    """Count of ``opcode`` instructions per kernel of one built library's
    SASS (``cuobjdump -sass``), or None where the toolkit has no
    ``cuobjdump``."""
    tool = Path(_build._nvcc()).parent / "cuobjdump"
    if not tool.exists():
        return None
    sass = subprocess.run([str(tool), "-sass", str(_build._lib_path(lib))],
                          capture_output=True, text=True, timeout=300)
    if sass.returncode != 0:
        return None
    counts, key = {}, None
    for ln in sass.stdout.splitlines():
        m = re.search(r"Function : (\w+)", ln)
        if m:
            key = func_key(m.group(1))
            if key:
                counts[key] = 0
        elif key and re.search(rf"\b{opcode}\b", ln):
            counts[key] += 1
    return counts


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
    # one launch steps every live cohort: at most one launch a chunk of the
    # longest cohort (a launch per cohort would sum the cohorts' chunks)
    max_launches = grid.steps // rt._RNG_CHUNK
    if launches["fused_steps"] > max_launches:
        fail(f"the main path launched fused_steps {launches['fused_steps']} "
             f"times for a grid of {max_launches} chunks: one launch must "
             f"step every live cohort")
    # kernel ms and the host's share of one sweep (after the counted run)
    sweep = ssplit.grid(DEV)
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
                                  art.rows[-1].n_threads],
         max_launches=max_launches,
         sweep={k: sweep[k] for k in (
             "launches", "grid_wall_s", "run_wall_s", "kernel_ms",
             "device_busy_ms", "kernel_ms_per_launch", "host_share_of_grid",
             "kernel_cell_steps_per_s", "host_split_s")})
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


def gathered_rows(cohorts, ci_before, ci_after):
    """``(kd_rows, se_rows)``: the distinct rows of the trace tables (which
    every cohort shares) that one launch can have read, from the cells'
    cursors before and after it.  A cell reads ``se`` at every cursor
    position it passes, and ``kd`` for the suboperations of the ops its
    threads held at the start or fetched."""
    c0 = cohorts[0]
    n = c0.n_trace
    se = c0.se[:n].cpu().numpy()
    ops_len = (se[:, 1] - se[:, 0]).astype(np.int64)
    kd_ops = np.zeros(n, bool)
    se_ops = np.zeros(n, bool)
    for c, before, after in zip(cohorts, ci_before, ci_after):
        held = (c.nthr_g.cpu().numpy().astype(np.int64)
                * c.substep.flags["n_cores"])
        for g in range(c.G):
            cur = int(before[g, 0])
            adv = int(after[g, 2]) - int(before[g, 2])
            se_ops[np.arange(cur, cur + adv + 1) % n] = True
            kd_ops[np.arange(cur - held[g], cur + adv + 1) % n] = True
    return int(ops_len[kd_ops].sum()), int(se_ops.sum())


def plan_main(sc, art):
    """The main path's cohorts from their initial states, and four chunks
    of their uniforms side by side (what one grouped launch takes)."""
    cohorts = rt.plan_grid(sc.sim_config(), art.trace_result.trace,
                           sc.latencies_sec(), sc.thread_candidates,
                           n_ops=sc.n_ops, device=DEV)
    return cohorts, [rt.cohort_uniforms(cohorts, ck) for ck in range(4)]


def phase_sched_split(cohorts, us):
    """The measured split of a scheduler step at the main path's shape: the
    profiling instance of the grouped launch, ``SPLIT_LAUNCHES`` launches
    from the initial states, per cohort the SM cycles of each phase a step
    (``ssplit.PHASES``), the idle skips a step, and the chain floor -- the
    phases the next pop waits for, times K, for the slowest cohort.  The
    profiling instance must leave every plane as the normal one does."""
    prof, same = ssplit.measure_split(cohorts, us)
    if not same:
        fail("the profiling instance of fused_steps changed a state plane")
    state = card_state()
    mhz = state["sm_mhz"]
    K = us[0].shape[0]
    rows = ssplit.split_rows(prof, [c.G for c in cohorts],
                             ssplit.SPLIT_LAUNCHES * K, mhz)
    if not all(r["total_cycles_per_step"] > 0
               and min(r["cycles_per_step"].values()) >= 0 for r in rows):
        fail(f"the profiling instance returned a malformed split: {rows}")
    chain = max(r["chain_cycles_per_step"] for r in rows)
    floor_ms = ssplit.chain_floor_ms(chain, K, mhz)
    emit("sched_split", phases=list(ssplit.PHASES),
         chain_phases=list(ssplit.CHAIN_PHASES), K=K,
         launches=ssplit.SPLIT_LAUNCHES, card_state=state,
         cohorts=[dict(T_max=c.T_max, **r) for c, r in zip(cohorts, rows)],
         chain_cycles_per_step=chain, chain_floor_ms=floor_ms,
         bit_equal_to_normal_instance=True,
         note="clock64 stamps at phase boundaries (a stamp does not wait "
              "for a load in flight: a load's latency shows where its "
              "value is first used); cycles converted at the SM clock read "
              "after the launches; the floor is K steps of the chain "
              "phases of the slowest cohort")
    return floor_ms, rows


def phase_timing(cohorts, us, floor_ms):
    """Per-launch time of ``fused_steps`` at the main path's shape: the
    grouped launch of all four cohorts (512 cells, K = 1024 steps) and each
    cohort alone, in turns; one grouped chunk from the initial states held
    bit-equal to the plain version for every cohort, whose time for the
    same K steps is the plain time; and the grouped launch's bounds."""
    reps = 8
    ms = ssplit.time_launches(cohorts, us, reps=reps, rounds=2)
    K = us[0].shape[0]
    # the same launches again, untimed, for the table rows they read
    states = ssplit.copy_states([c.state for c in cohorts])
    ssplit.launch_group(cohorts, states, us[0])
    kd_rows = se_rows = 0
    for i in range(reps):
        before = [s[1].cpu().numpy() for s in states]
        ssplit.launch_group(cohorts, states, us[i % len(us)])
        kd_n, se_n = gathered_rows(cohorts, before,
                                   [s[1].cpu().numpy() for s in states])
        kd_rows += kd_n
        se_rows += se_n
    kd_rows, se_rows = kd_rows / reps, se_rows / reps
    G = sum(c.G for c in cohorts)
    sbytes = sum(state_bytes(c.state) for c in cohorts)
    # bytes one launch must move: state in and out, the uniform block,
    # the per-cell vectors (L_mem f64, nthr i32, warm i32), and the table
    # rows it gathers (two f64 a row), each counted once
    nbytes = (2 * sbytes + us[0].numel() * 8 + G * 16
              + (kd_rows + se_rows) * 16)
    P = cohorts[0].state[5].shape[-1]
    # f64 operations of one step of one cell: two ops per ring slot and
    # per window slot (key select + min), ~64 scalar ops
    flops = sum(K * c.G * (2 * c.state[2].shape[1] + 2 * P + 64)
                for c in cohorts)
    b_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    b_ops = flops / F64_FLOP_PER_S * 1e3
    group_ms = float(np.mean(ms["group"]))

    # one grouped chunk against the plain version, cohort by cohort (the
    # plain version grants through the plain token clock: no CUDA kernel)
    kern = ssplit.copy_states([c.state for c in cohorts])
    ssplit.launch_group(cohorts, kern, us[0])
    before = tc.token_clock_update.launches
    plain_ms, err, off = [], 0.0, 0
    for c, s_kern in zip(cohorts, kern):
        sub = sk.make_substep(**c.substep.flags,
                              token_clock=tc.token_clock_update_ref)
        u0 = us[0][:, :, off:off + c.G]
        off += c.G
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        s = c.state
        start.record()
        for k in range(K):
            s = sub(s, u0[k], c.kd, c.se, c.arr, c.nthr_g, c.n_trace,
                    c.L_mem_g, c.warm_g, c.n_ops, c.dyn)
        end.record()
        torch.cuda.synchronize()
        plain_ms.append(start.elapsed_time(end))
        ok, e, bad = cases.states_agree(s, s_kern, False)
        err = max(err, e)
        if not ok:
            fail(f"fused_steps (grouped launch of {len(cohorts)} cohorts) "
                 f"disagrees with the plain version at the main path's "
                 f"shape on the T={c.T_max} cohort after {K} steps: plane "
                 f"{bad}, max abs err {e}")
    if tc.token_clock_update.launches != before:
        fail("the plain version used for the comparison launched the "
             "token-clock kernel")
    rows = [{"T_max": c.T_max, "G": c.G,
             "NS": sk.slot_count(c.state[2].shape[1]), "K": K,
             "n_u": c.n_u, "ms_alone": t,
             "us_per_step_alone": [x * 1e3 / K for x in t],
             "plain_ms": p, "state_bytes": state_bytes(c.state)}
            for c, t, p in zip(cohorts, ms["alone"], plain_ms)]
    group = {"cohorts": len(cohorts), "G": G, "K": K, "ms": ms["group"],
             "us_per_step": group_ms * 1e3 / K,
             "bound_bytes_ms": b_bytes, "bound_ops_ms": b_ops,
             "serial_chain_ms": floor_ms, "state_bytes": sbytes,
             "u_block_bytes": us[0].numel() * 8,
             "kd_rows_gathered": kd_rows, "se_rows_gathered": se_rows,
             "kd_rows_total": int(cohorts[0].kd.shape[0]),
             "se_rows_total": int(cohorts[0].se.shape[0]),
             "plain_ms": sum(plain_ms),
             "kernel_cell_steps_per_s": G * K / (group_ms * 1e-3),
             "bit_equal_to_plain_all_cohorts": True}
    emit("timing", fused_steps_group=group, fused_steps_alone=rows,
         timing="CUDA events over 8 launches a turn, two turns: group, each "
                "cohort alone, group, each cohort alone",
         note="the bytes and operations bounds are both about a "
              "microsecond; the binding limit is neither but the serial "
              "chain: K dependent steps per cell (serial_chain_ms is its "
              "floor from the measured split, us_per_step what a step "
              "takes)")
    return group, err


# -- paged decode attention and the serving path -------------------------------


def _paged_check(checks, worst, name, args, dtype, **kw):
    """One kernel launch held against the plain version on the same inputs;
    appends a record naming the instance and the split count, fails on a
    disagreement (``PAGED_TOL`` absolute, ``PAGED_ROW_TOL`` relative to each
    row).  Returns the output."""
    plan = pk.launch_plan(*args, **kw)
    got = pk.paged_decode_attention(*args, **kw)
    want = paged_decode_attention_ref(*args)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    row = cases.row_rel_err(got, want)
    tol = cases.PAGED_TOL[dtype]
    checks.append({"case": name, "dtype": dtype,
                   "instance": plan["instance"],
                   "n_splits": plan["n_splits"], "pps": plan["pps"],
                   "n_buffers": kw.get("n_buffers", 2), "max_abs_err": err,
                   "tol": tol, "max_row_rel_err": row,
                   "row_tol": PAGED_ROW_TOL})
    worst[dtype] = max(worst[dtype], err)
    if not (bool(torch.isfinite(got).all()) and err <= tol
            and row <= PAGED_ROW_TOL):
        fail(f"paged_decode_attention ({plan['instance']}) disagrees with "
             f"its plain version on {name}, {kw}: max abs err {err} (limit "
             f"{tol}), row-relative {row} (limit {PAGED_ROW_TOL})")
    return got


def phase_paged_checks(seed):
    """The paged attention kernel against its plain version on the card,
    both instances (every case in bfloat16 and in float32): the reference's
    five ``PAGED_CASES``, the length-1 / exactly-full edge case and the
    serving shape at n_buffers 2, 3, 4; ``PAGED_SPLIT_CASES`` at their
    forced split counts, each run twice and required to repeat bit for bit;
    tables holding page ids outside the store at the plan's, 1 and 3
    splits; and the kernel bench's shape, each within the reference's own
    tolerance (3e-2 bfloat16, 5e-5 float32) and within ``PAGED_ROW_TOL`` of
    each (b, query head) row's norm."""
    checks, worst = [], {"bfloat16": 0.0, "float32": 0.0}
    named = [(f"paged-{i}", c) for i, c in enumerate(cases.PAGED_CASES)]
    named += [("edge-len1-full", cases.PAGED_EDGE),
              ("serve-shape", cases.PAGED_SERVE)]
    for name, case in named:
        c = cases.make_paged_case(case, seed=1)
        for dt in ("bfloat16", "float32"):
            args = cases.paged_tensors(c, DEV, dt)
            for nb in (2, 3, 4):
                _paged_check(checks, worst, name, args, dt, n_buffers=nb)
    for name, case in cases.PAGED_SPLIT_CASES.items():
        c = cases.make_paged_case(case, seed=1)
        for dt in ("bfloat16", "float32"):
            args = cases.paged_tensors(c, DEV, dt)
            kw = dict(n_splits=case["n_splits"])
            first = _paged_check(checks, worst, name, args, dt, **kw)
            second = _paged_check(checks, worst, name, args, dt, **kw)
            if not torch.equal(first, second):
                fail(f"paged_decode_attention on {name} ({dt}) does not "
                     f"repeat bit for bit")
            checks[-1]["repeats_bit_for_bit"] = True
    for i, case in enumerate(cases.PAGED_CASES):
        c = cases.with_bad_page_ids(cases.make_paged_case(case, seed=6))
        for dt in ("bfloat16", "float32"):
            args = cases.paged_tensors(c, DEV, dt)
            for n_splits in (None, 1, 3):
                _paged_check(checks, worst, f"out-of-store-ids-{i}", args,
                             dt, n_splits=n_splits)
    # the kernel bench's shape (a full 17.2 GB store, inputs drawn as the
    # bench draws them): the whole batch through the kernel, every sequence
    # against the plain version, PAGED_BENCH_CHUNK sequences a call
    pb = cases.PAGED_BENCH
    q, kp, vp, bt, ln = kbench.paged_inputs(pb["B"], pb["Hq"], pb["Hkv"],
                                            pb["S"], DEV, seed)
    plan = pk.launch_plan(q, kp, vp, bt, ln)
    got = pk.paged_decode_attention(q, kp, vp, bt, ln)
    finite = bool(torch.isfinite(got).all())
    err, row, plain_ms = 0.0, 0.0, 0.0
    for i in range(0, pb["B"], PAGED_BENCH_CHUNK):
        j = i + PAGED_BENCH_CHUNK
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        want = paged_decode_attention_ref(q[i:j], kp, vp, bt[i:j], ln[i:j])
        end.record()
        torch.cuda.synchronize()
        plain_ms += start.elapsed_time(end)
        err = max(err, float((got[i:j].float() - want.float()).abs().max()))
        row = max(row, cases.row_rel_err(got[i:j], want))
        del want
    del q, kp, vp, bt, ln, got
    torch.cuda.empty_cache()
    checks.append({"case": "bench-shape", "n_buffers": 2,
                   "dtype": pb["dtype"], "instance": plan["instance"],
                   "n_splits": plan["n_splits"], "max_abs_err": err,
                   "tol": cases.PAGED_TOL[pb["dtype"]],
                   "max_row_rel_err": row, "row_tol": PAGED_ROW_TOL,
                   "sequences_checked": pb["B"],
                   "plain_chunk": PAGED_BENCH_CHUNK})
    worst["bfloat16"] = max(worst["bfloat16"], err)
    if not (finite and err <= cases.PAGED_TOL[pb["dtype"]]
            and row <= PAGED_ROW_TOL):
        fail(f"paged_decode_attention at the bench shape: max abs err {err}, "
             f"row-relative {row} (limit {PAGED_ROW_TOL}) over all "
             f"{pb['B']} sequences (finite: {finite})")
    worst_row = {dt: max(c["max_row_rel_err"] for c in checks
                         if c["dtype"] == dt) for dt in worst}
    emit("paged_checks", n_checks=len(checks), max_abs_err_by_dtype=worst,
         max_row_rel_err_by_dtype=worst_row, checks=checks,
         plain_ms_bench=plain_ms)
    return worst, worst_row, plain_ms


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
    paged_by_instance = dict(pk.paged_decode_attention.launches_by_instance)
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
    # the model is bfloat16: every paged launch is the tensor-core instance
    if paged_by_instance != {"scalar_f32": 0, "mma_bf16":
                             launches["paged_decode_attention"]}:
        fail(f"paged_decode_attention launches in the serving window by "
             f"instance: {paged_by_instance}, not all mma_bf16")
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
         paged_launches_by_instance=paged_by_instance,
         launches_per_decode_step=(launches["paged_decode_attention"]
                                   / st["decode_steps"]),
         peak_device_bytes=int(peak), pages_released=True,
         decode_profile=prof)
    return eng, reqs, logs, picks, launches, paged_by_instance


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


#: GPU cycles the card sleeps before each separately timed launch, so that
#: the host has queued the call (the wrapper's checks and allocations)
#: before its start event is reached: the events then time the device's
#: work alone (about 0.2 ms at 1.5-2 GHz)
CUSHION_CYCLES = 300_000
#: bytes written between launches to push the page store out of the 50 MB L2
L2_FLUSH_BYTES = 128 << 20


def device_ms(fn, reps, flush=None):
    """Mean device milliseconds of one call of ``fn``, each call timed by its
    own events behind a ``CUSHION_CYCLES`` sleep (and, given ``flush``, a
    write of that buffer first).  A loop of back-to-back calls measures the
    host when a call is shorter than the wrapper's host work."""
    pairs = []
    for _ in range(reps):
        if flush is not None:
            flush.fill_(1.0)
        torch.cuda._sleep(CUSHION_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / reps


def phase_paged_timing():
    """The kernel, its plain version and the two-call composition at the
    serving shape (bf16 and, for ``scalar_f32``, float32) and at a 32k
    context: the kernel's device time per call (``device_ms``; at the
    serving shape also with L2 flushed between calls), the mean of a loop
    of back-to-back calls, and the kernel at ring depths ``DEPTHS`` (each
    depth's ring in ``ring_by_n_buffers``; a depth whose ring does not fit
    in shared memory is listed in ``n_buffers_refused``).  Every launch
    timed is first held to ``PAGED_TOL`` and ``PAGED_ROW_TOL``."""
    rows = []
    flush = torch.empty(L2_FLUSH_BYTES // 4, device=DEV)
    for name, case, dt, reps in (
            ("serve", cases.PAGED_SERVE, "bfloat16", 50),
            ("serve-f32", cases.PAGED_SERVE, "float32", 20),
            ("long-32k", cases.PAGED_LONG, "bfloat16", 10)):
        c = cases.make_paged_case(case, seed=5)
        c["dtype"] = dt
        args = cases.paged_tensors(c, DEV)
        plan = pk.launch_plan(*args)
        want = paged_decode_attention_ref(*args)
        comp = paged_composition(*args)
        torch.cuda.synchronize()
        comp_err = float((comp.float() - want.float()).abs().max())
        tol = cases.PAGED_TOL[dt]
        # the prefetch depth P of the paper's model: pages in flight ahead
        ring_by_depth, refused, err, row = {}, {}, 0.0, 0.0
        for nb in DEPTHS:
            try:
                ring_by_depth[nb] = pk.launch_plan(*args, n_buffers=nb)["ring"]
            except ValueError as e:
                refused[nb] = str(e)
                continue
            got = pk.paged_decode_attention(*args, n_buffers=nb)
            torch.cuda.synchronize()
            err = max(err, float((got.float() - want.float()).abs().max()))
            row = max(row, cases.row_rel_err(got, want))
        if not (err <= tol and row <= PAGED_ROW_TOL):
            fail(f"paged_decode_attention at the {name} shape: max abs err "
                 f"{err} (limit {tol}), row-relative {row} (limit "
                 f"{PAGED_ROW_TOL})")
        device_ms(lambda: pk.paged_decode_attention(*args), 3)   # warm-up
        ms = device_ms(lambda: pk.paged_decode_attention(*args), reps)
        ms_loop = cuda_ms(lambda: pk.paged_decode_attention(*args), reps)
        ms_by_depth = {nb: device_ms(lambda nb=nb: pk.paged_decode_attention(
            *args, n_buffers=nb), reps) for nb in ring_by_depth}
        ms_flushed = (device_ms(lambda: pk.paged_decode_attention(*args),
                                reps, flush) if name == "serve" else None)
        plain_ms = cuda_ms(lambda: paged_decode_attention_ref(*args),
                           max(2, reps // 5))
        comp_ms = device_ms(lambda: paged_composition(*args), reps)
        comp_ms_loop = cuda_ms(lambda: paged_composition(*args), reps)
        bound_ms, bound_by, nbytes, flops = paged_bound(c)
        B, Hq, D = c["q"].shape
        rows.append({"shape": name, "B": B, "Hq": Hq,
                     "Hkv": c["k_pages"].shape[2], "D": D,
                     "page": c["k_pages"].shape[1],
                     "ppseq": c["block_tables"].shape[1],
                     "dtype": dt, "instance": plan["instance"],
                     "n_splits": plan["n_splits"], "pps": plan["pps"],
                     "smem_bytes": plan["smem"],
                     "workspace_bytes": plan["workspace_bytes"],
                     "tokens": int(c["lengths"].sum()),
                     "max_len": int(c["lengths"].max()), "ms": ms,
                     "ms_loop": ms_loop, "ms_l2_flushed": ms_flushed,
                     "ms_by_n_buffers": ms_by_depth,
                     "ring_by_n_buffers": ring_by_depth,
                     "n_buffers_refused": refused,
                     "plain_ms": plain_ms, "composition_ms": comp_ms,
                     "composition_ms_loop": comp_ms_loop,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "bytes": nbytes, "flops": flops,
                     "roofline_share": bound_ms / ms,
                     "achieved_bytes_per_s": nbytes / (ms * 1e-3),
                     "max_abs_err": err, "max_row_rel_err": row,
                     "composition_max_abs_err": comp_err})
        del args, want, got, comp
        torch.cuda.empty_cache()
    del flush
    torch.cuda.empty_cache()
    emit("paged_timing", rows=rows,
         timing="ms: device time per call by its own events behind a "
                f"{CUSHION_CYCLES}-cycle sleep, after 3 such calls "
                "untimed; ms_loop: mean of back-to-"
                "back calls (host-bound when a call is short); "
                f"ms_l2_flushed: {L2_FLUSH_BYTES >> 20} MiB written before "
                "each call (composition_ms and composition_ms_loop: the "
                "same two measures of the composition)",
         composition="k_pages[block_tables] gather + "
                     "F.scaled_dot_product_attention(enable_gqa=True, "
                     "attn_mask=length mask): two calls, timed together")
    return rows


# -- the kernel-ops entry point: flash attention, wkv6, the kernel bench -------


def phase_flash_checks(seed):
    """The flash kernel against its plain version on the card: the
    reference's six ``FLASH_CASES``, ``FLASH_LONG`` (1, 4096, 32/8 heads,
    D 128, bf16, causal) and the ``FLASH_TC_CASES`` (every layout of the
    tensor-core instance), within the reference's tolerance and
    ``FLASH_ROW_TOL`` relative to each row; then both ``FLASH_BENCH`` shapes
    against the port's blockwise twin (``models.layers.attention``, float32
    online softmax over 1024-key blocks), where the plain version's S x S
    scores would need 17-137 GB, within 3e-2 absolute and ``FLASH_ROW_TOL``.
    Each check names the instance that ran it.  The twin's time at the bench
    shapes and the plain version's at ``FLASH_LONG`` are the plain times of
    the kernels line."""
    checks, worst = [], {"bfloat16": 0.0, "float32": 0.0}
    worst_row = {"bfloat16": 0.0, "float32": 0.0}
    named = [(f"flash-{i}", c) for i, c in enumerate(cases.FLASH_CASES)]
    named.append(("long-4096", cases.FLASH_LONG))
    named += [(f"tc-{i}", c) for i, c in enumerate(cases.FLASH_TC_CASES)]
    plain_long_ms = None
    for name, case in named:
        c = cases.make_flash_case(case, seed=0)
        q, k, v = cases.flash_tensors(c, DEV)

        def plain():
            return flash_attention_ref(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                c["causal"], c["window"]).transpose(1, 2)

        before = dict(fa.flash_attention.launches_by_instance)
        got = fa.flash_attention(q, k, v, causal=c["causal"],
                                 sliding_window=c["window"],
                                 block_q=c["block_q"], block_k=c["block_k"])
        want = plain()
        torch.cuda.synchronize()
        ran = [i for i, n in fa.flash_attention.launches_by_instance.items()
               if n != before[i]]
        err = float((got.float() - want.float()).abs().max())
        row = cases.row_rel_err(got, want)
        tol = cases.tol(c["dtype"])
        checks.append({"case": name, "shape": list(case[:5]),
                       "causal": c["causal"], "window": c["window"],
                       "dtype": c["dtype"], "instance": ran,
                       "max_abs_err": err, "tol": tol,
                       "max_row_rel_err": row, "row_tol": FLASH_ROW_TOL})
        worst[c["dtype"]] = max(worst[c["dtype"]], err)
        worst_row[c["dtype"]] = max(worst_row[c["dtype"]], row)
        if ran != [fa.instance_for(q.dtype)]:
            fail(f"flash_attention on {name} ({c['dtype']}) ran {ran}")
        if not (err <= tol and row <= FLASH_ROW_TOL):
            fail(f"flash_attention disagrees with its plain version on "
                 f"{name}: max abs err {err} (limit {tol}), row-relative "
                 f"{row} (limit {FLASH_ROW_TOL})")
        if name == "long-4096":
            plain_long_ms = cuda_ms(plain, 1)
        del q, k, v, got, want
    twin = []
    for B, Hq, Hkv, S in cases.FLASH_BENCH:
        t = flash_vs_twin(B, Hq, Hkv, S, seed)
        if not (t["finite"] and t["max_abs_err_vs_twin"] <= t["tol"]
                and t["max_row_rel_err_vs_twin"] <= t["row_tol"]):
            fail(f"flash_attention at B{B} S{S} against the blockwise twin: "
                 f"{t}")
        worst["bfloat16"] = max(worst["bfloat16"], t["max_abs_err_vs_twin"])
        twin.append(t)
    emit("flash_checks", n_checks=len(checks) + len(twin),
         max_abs_err_by_dtype=worst, max_row_rel_err_by_dtype=worst_row,
         checks=checks, bench_vs_twin=twin, plain_ms_long_4096=plain_long_ms,
         twin="repro_torch.models.layers.attention (blockwise, 1024-key "
              "blocks, float32)")
    return worst, twin, plain_long_ms


def flash_vs_twin(B, Hq, Hkv, S, seed):
    """The flash kernel and the blockwise twin on the bench's inputs at one
    ``FLASH_BENCH`` shape: the largest absolute error, the largest error of
    a query row relative to the row (``FLASH_ROW_TOL``), whether the output
    is finite, and the twin's time (one launch after the compared one)."""
    q, k, v = kbench.flash_inputs(B, Hq, Hkv, S, DEV, seed)

    def blockwise():
        return layers.attention(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), causal=True)

    got = fa.flash_attention(q, k, v, causal=True)
    want = blockwise().transpose(1, 2).float()
    torch.cuda.synchronize()
    err = float((got.float() - want).abs().max())
    row = cases.row_rel_err(got, want)
    finite = bool(torch.isfinite(got).all())
    del got, want
    torch.cuda.empty_cache()
    twin_ms = cuda_ms(blockwise, 1)
    del q, k, v
    torch.cuda.empty_cache()
    return {"shape": [B, Hq, Hkv, S, 128], "dtype": "bfloat16",
            "finite": finite, "max_abs_err_vs_twin": err,
            "tol": cases.tol("bfloat16"), "max_row_rel_err_vs_twin": row,
            "row_tol": FLASH_ROW_TOL, "twin_ms": twin_ms}


def phase_wkv_checks(seed):
    """The wkv6 kernel against its plain version (the sequential float32
    recurrence): the reference's four ``WKV_CASES``, the ``WKV_TC_CASES`` of
    the tensor-core instance, both strong-decay patterns with log_w in
    float32 and bf16, and ``WKV_BENCH`` (rwkv6-3b's width, inputs drawn on
    the card as the bench draws them).  Each within the reference's scaled
    tolerance and ``WKV_ROW_TOL`` of each (b, t, h) row, run by the instance
    of its dtype (named in the check), finite, and the same bits from a
    second call and from a call with the caller's chunk 1 (the kernels'
    results do not depend on it).  The plain version's time at
    ``WKV_BENCH``."""
    checks = []
    worst = {"bfloat16": 0.0, "float32": 0.0}
    worst_row = {"bfloat16": 0.0, "float32": 0.0}
    named = [(f"wkv-{i}", c, None) for i, c in enumerate(cases.WKV_CASES)]
    named += [(f"tc-{i}", c, None) for i, c in enumerate(cases.WKV_TC_CASES)]
    named += [(f"decay-{d}-{w}", (2, 1024, 2, 64, 32, "bfloat16", w), d)
              for d in cases.WKV_DECAYS for w in ("float32", "bfloat16")]
    for name, case, decay in named:
        c = cases.make_wkv_case(case, seed=0, decay=decay)
        args = cases.wkv_tensors(c, DEV)
        checks.append(wkv_check(name, list(case[:4]), c["chunk"],
                                c["dtype"], args))
    B, S, H, D = cases.WKV_BENCH
    args = kbench.wkv_inputs(B, S, H, D, DEV, seed)
    checks.append(wkv_check("bench", [B, S, H, D], 64, "bfloat16", args))
    plain_ms = cuda_ms(lambda: wkv6_ref(*args), 1)
    del args
    torch.cuda.empty_cache()
    for ck in checks:
        dt = ck["dtype"]
        worst[dt] = max(worst[dt], ck["scaled_max_abs_err"])
        worst_row[dt] = max(worst_row[dt], ck["max_row_rel_err"])
    emit("wkv_checks", n_checks=len(checks), max_abs_err_by_dtype=worst,
         max_row_rel_err_by_dtype=worst_row, checks=checks,
         plain_ms_bench=plain_ms)
    return worst, worst_row, plain_ms


def wkv_check(name, shape, chunk, dtype, args):
    """One wkv6 check of :func:`phase_wkv_checks`; fails the run."""
    before = dict(wk.wkv6.launches_by_instance)
    got = wk.wkv6(*args, chunk=chunk)
    want = wkv6_ref(*args)
    torch.cuda.synchronize()
    ran = [i for i, n in wk.wkv6.launches_by_instance.items()
           if n != before[i]]
    same_bits = bool(torch.equal(wk.wkv6(*args, chunk=chunk), got)
                     and torch.equal(wk.wkv6(*args, chunk=1), got))
    err = cases.wkv_err(got, want)
    row = cases.row_rel_err(got, want)
    tol = cases.tol(dtype)
    finite = bool(torch.isfinite(got).all())
    check = {"case": name, "shape": shape, "chunk": chunk, "dtype": dtype,
             "log_w": str(args[3].dtype).replace("torch.", ""),
             "instance": ran, "scaled_max_abs_err": err, "tol": tol,
             "max_row_rel_err": row, "row_tol": cases.WKV_ROW_TOL,
             "finite": finite, "same_bits_repeat_and_chunk_1": same_bits}
    if ran != [wk.instance_for(getattr(torch, dtype))]:
        fail(f"wkv6 on {name} ({dtype}) ran {ran}")
    if not (finite and err <= tol and row <= cases.WKV_ROW_TOL and same_bits):
        fail(f"wkv6 disagrees with its plain version on {name}: {check}")
    return check


def phase_kernels_bench(seed):
    """The slice's main path: ``benchmarks.kernels_bench_torch`` runs its
    three benches through ``repro_torch.kernels.ops`` at the reference's
    full-width shapes.  The counts are set to 0 just before and read just
    after; every bench row must be finite."""
    reset_counts()
    t0 = time.perf_counter()
    rows = {fn.__name__: fn(seed) for fn in kbench.ALL}
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = counts()
    flash_by_instance = dict(fa.flash_attention.launches_by_instance)
    paged_by_instance = dict(pk.paged_decode_attention.launches_by_instance)
    wkv_by_instance = dict(wk.wkv6.launches_by_instance)
    for name in ("flash_attention", "paged_decode_attention", "wkv6"):
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched on the kernels_bench path")
    # the bench's flash inputs are bf16: every launch is the wgmma instance
    if flash_by_instance != {**dict.fromkeys(fa.INSTANCES, 0),
                             "wgmma_bf16": launches["flash_attention"]}:
        fail(f"flash_attention launches in the kernels_bench window by "
             f"instance: {flash_by_instance}, not all wgmma_bf16")
    if paged_by_instance != {"scalar_f32": 0, "mma_bf16":
                             launches["paged_decode_attention"]}:
        fail(f"paged_decode_attention launches in the kernels_bench window "
             f"by instance: {paged_by_instance}, not all mma_bf16")
    # ... and its wkv6 inputs bf16: every launch is the tensor-core instance
    if wkv_by_instance != {"scalar_f32": 0,
                           "chunk_tc_bf16": launches["wkv6"]}:
        fail(f"wkv6 launches in the kernels_bench window by instance: "
             f"{wkv_by_instance}, not all chunk_tc_bf16")
    if launches["fused_steps"] or launches["token_clock_update"]:
        fail(f"the kernels_bench path launched a scheduler kernel: "
             f"{launches}")
    for bench in rows.values():
        for row in bench:
            if row.get("measured", True) and not (
                    math.isfinite(row["ms"]) and row["ms"] > 0):
                fail(f"kernels_bench row {row['name']}: time {row['ms']}")
    emit("kernels_bench", wall_s=wall_s, launches=launches,
         flash_launches_by_instance=flash_by_instance,
         paged_launches_by_instance=paged_by_instance,
         wkv_launches_by_instance=wkv_by_instance, rows=rows,
         peak_flops=kbench.PEAK_FLOPS, hbm_bytes_per_s=kbench.HBM_BW)
    return rows, launches, flash_by_instance, wkv_by_instance


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the served model's weights and prompts, "
                         "and of the kernel checks' and bench's inputs at "
                         "full width")
    args = ap.parse_args()
    t_all = time.perf_counter()
    torch.cuda.set_device(0)
    card, sm_mhz = phase_card()
    (flash_ptx, flash_hgmma_count, paged_ptx, paged_hmma, sched_ptx,
     sched_sass, wkv_ptx, wkv_sass) = phase_build()

    sc_small = scenario(2, (8,), n_keys=2000, n_wl_ops=600)
    store, wl = Experiment(sc_small).build()
    small_trace = run_trace(store, wl, warmup_frac=sc_small.warmup_frac).trace
    err_fused, sets = phase_fused_flag_sets(small_trace)
    emit("kernel_checks", fused_steps_flag_sets=sets,
         fused_steps_max_abs_err=err_fused,
         tolerance="every plane bit-equal; histogram: equal, or unit mass "
                   "moved between adjacent bins, same row total")
    paged_err, paged_row, paged_bench_plain_ms = phase_paged_checks(
        args.seed)
    flash_err, flash_twin, flash_plain_long_ms = phase_flash_checks(args.seed)
    wkv_err, wkv_row, wkv_plain_ms = phase_wkv_checks(args.seed)

    sc, art, launches = phase_main_path()
    plain_launches = phase_plain_step_path(art)
    phase_agreement(sc, art)
    cohorts, us = plan_main(sc, art)
    floor_ms, split = phase_sched_split(cohorts, us)
    group, err_main = phase_timing(cohorts, us, floor_ms)
    widest = cohorts[-1]
    tok = phase_token_clock(widest.G, widest.state[6].shape[1]
                            if len(widest.state) > 6 else 1)
    tok["launches"] = plain_launches["token_clock_update"]
    tok["path"] = "plain_step_path"
    tok["launches_main_path"] = launches["token_clock_update"]
    fused = dict(
        name="sched_step.fused_steps", route="cuda",
        source="src/repro_torch/kernels/csrc/sched_step.cu",
        replaces="src/repro/kernels/sched_step.py:622",
        launches=launches["fused_steps"], path="main_path",
        max_abs_err=max(err_fused, err_main),
        ms=float(np.mean(group["ms"])), ms_turns=group["ms"],
        us_per_step=group["us_per_step"], plain_ms=group["plain_ms"],
        bound_ms=max(group["bound_bytes_ms"], group["bound_ops_ms"]),
        bound_by=("bytes" if group["bound_bytes_ms"]
                  >= group["bound_ops_ms"] else "operations"),
        bound_bytes_ms=group["bound_bytes_ms"],
        bound_ops_ms=group["bound_ops_ms"],
        serial_chain_ms=floor_ms,
        serial_chain="measured: K steps of the chain phases of the "
                     "slowest cohort (sched_split phase)",
        binding="the serial chain (latency of K dependent steps), which "
                "neither the bytes nor the operations bound describes",
        library_ms=None,
        shape={"cohorts": group["cohorts"], "G": group["G"],
               "T": [c.state[2].shape[1] for c in cohorts], "K": group["K"]},
        ptxas=sched_ptx, sass=sched_sass,
        tolerance="bit-equal (histogram: adjacent-bin rule)")

    eng, reqs, logs, picks, serve_launches, serve_paged_by_instance = \
        phase_serve_path(args.seed)
    phase_serve_dense_check(eng, reqs, logs, picks)
    del eng, logs
    torch.cuda.empty_cache()
    serve_row, serve_f32_row, long_row = phase_paged_timing()
    paged = dict(
        name="paged_kv_gather.paged_decode_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/paged_kv_gather.cu",
        replaces="src/repro/kernels/paged_kv_gather.py:124",
        launches=serve_launches["paged_decode_attention"], path="serve_path",
        launches_by_instance=serve_paged_by_instance,
        max_abs_err=max(paged_err.values()),
        max_abs_err_by_dtype=paged_err, max_row_rel_err_by_dtype=paged_row,
        ms=serve_row["ms"],
        plain_ms=serve_row["plain_ms"], bound_ms=serve_row["bound_ms"],
        bound_by=serve_row["bound_by"], library_ms=None,
        composition_ms=serve_row["composition_ms"],
        composition_ms_loop=serve_row["composition_ms_loop"],
        composition="two calls, no single PyTorch call computes it: "
                    "k_pages[block_tables] + scaled_dot_product_attention",
        instance=serve_row["instance"], n_splits=serve_row["n_splits"],
        ms_l2_flushed=serve_row["ms_l2_flushed"],
        ms_loop=serve_row["ms_loop"],
        ms_by_n_buffers=serve_row["ms_by_n_buffers"],
        ring_by_n_buffers=serve_row["ring_by_n_buffers"],
        shape={k: serve_row[k] for k in ("B", "Hq", "Hkv", "D", "page",
                                         "ppseq", "dtype", "tokens")},
        long_context={k: long_row[k] for k in (
            "B", "ppseq", "tokens", "instance", "n_splits", "ms", "ms_loop",
            "ms_by_n_buffers", "ring_by_n_buffers", "plain_ms",
            "composition_ms", "composition_ms_loop", "bound_ms", "bound_by", "roofline_share",
            "max_row_rel_err")},
        scalar_f32_serve={k: serve_f32_row[k] for k in (
            "instance", "n_splits", "ms", "ms_by_n_buffers",
            "ring_by_n_buffers", "n_buffers_refused", "plain_ms",
            "composition_ms", "bound_ms", "bound_by")},
        ptxas=paged_ptx, hmma=paged_hmma,
        tolerance=f"3e-2 bfloat16, 5e-5 float32 (absolute), and "
                  f"{PAGED_ROW_TOL} relative to each (b, query head) row")
    torch.cuda.empty_cache()
    bench, bench_launches, flash_by_instance, wkv_by_instance = \
        phase_kernels_bench(args.seed)
    paged["launches_kernels_bench"] = bench_launches["paged_decode_attention"]
    pb = bench["paged_decode_bench"][0]
    paged["kernels_bench"] = {k: pb[k] for k in (
        "shape", "ms", "composition_ms", "bound_ms", "bound_by", "bytes",
        "max_abs_diff_vs_composition", "n_splits", "instance")}
    paged["kernels_bench"]["plain_ms"] = paged_bench_plain_ms
    paged["kernels_bench"]["roofline_share"] = pb["bound_ms"] / pb["ms"]

    f_rows = bench["flash_attention_bench"]
    B, Hq, Hkv, S, D = f_rows[0]["shape"]
    flash = dict(
        name="flash_attention.flash_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:75",
        launches=bench_launches["flash_attention"], path="kernels_bench",
        max_abs_err=max(flash_err.values()),
        max_abs_err_by_dtype=flash_err, ms=f_rows[0]["ms"],
        plain_ms=flash_twin[0]["twin_ms"],
        plain="the port's blockwise twin, models.layers.attention (the "
              "S x S plain version needs 17 GB here); flash_attention_ref "
              "at (1, 4096): see plain_ms_long_4096",
        plain_ms_long_4096=flash_plain_long_ms,
        bound_ms=f_rows[0]["bound_ms"], bound_by=f_rows[0]["bound_by"],
        library_ms=f_rows[0]["library_ms"],
        library="F.scaled_dot_product_attention(is_causal=True, "
                "enable_gqa=True)",
        shape={"B": B, "Hq": Hq, "Hkv": Hkv, "S": S, "D": D,
               "dtype": "bfloat16", "causal": True},
        long_context=dict(zip(("ms", "library_ms", "plain_ms", "bound_ms"),
                              (f_rows[1]["ms"], f_rows[1]["library_ms"],
                               flash_twin[1]["twin_ms"],
                               f_rows[1]["bound_ms"])),
                          shape=f_rows[1]["shape"]),
        max_row_rel_err_vs_twin=max(t["max_row_rel_err_vs_twin"]
                                    for t in flash_twin),
        instance={"bfloat16": fa.instance_for(torch.bfloat16),
                  "float32": fa.instance_for(torch.float32)},
        launches_by_instance=flash_by_instance,
        tflops={f"B{r['shape'][0]}S{r['shape'][3]}": r["flops"] / r["ms"]
                / 1e9 for r in f_rows},
        ptxas=flash_ptx, hgmma=flash_hgmma_count,
        tolerance="3e-2 bfloat16, 5e-5 float32 (absolute), and "
                  f"{FLASH_ROW_TOL} relative to each query row")
    w_row = bench["wkv6_bench"][0]
    wkv = dict(
        name="wkv6.wkv6", route="cuda",
        source="src/repro_torch/kernels/csrc/wkv6.cu",
        replaces="src/repro/kernels/wkv6.py:56",
        launches=bench_launches["wkv6"], path="kernels_bench",
        max_abs_err=max(wkv_err.values()), max_abs_err_by_dtype=wkv_err,
        max_row_rel_err_by_dtype=wkv_row,
        ms=w_row["ms"], plain_ms=wkv_plain_ms, bound_ms=w_row["bound_ms"],
        bound_by=w_row["bound_by"], library_ms=None,
        library="none: no PyTorch call computes it",
        shape=dict(zip(("B", "S", "H", "D"), w_row["shape"]),
                   dtype="bfloat16 r/k/v, float32 log_w and u"),
        instance={"bfloat16": wk.instance_for(torch.bfloat16),
                  "float32": wk.instance_for(torch.float32)},
        launches_by_instance=wkv_by_instance,
        blocks_per_sm=wk.blocks_per_sm(w_row["shape"][3]),
        ptxas=wkv_ptx, sass=wkv_sass,
        tolerance="3e-2 bfloat16, 5e-5 float32, absolute after dividing by "
                  f"max|plain| + 1e-6, and {cases.WKV_ROW_TOL} relative to "
                  "each (b, t, h) row")
    kernels = [fused, tok, paged, flash, wkv]
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
