"""Where the time of the port's scheduler step goes, measured on an NVIDIA GPU.

The grid replay's kernel (``src/repro_torch/kernels/csrc/sched_step.cu``,
wrapper :func:`repro_torch.kernels.sched_step.fused_steps_group`) steps every
cell of a latency x threads grid, one warp a cell, K = 1024 dependent steps a
launch.  This bench measures it at the main path's shape -- the
``hash_index_2ssd`` scenario over 128 latencies 0.1-10 us x threads (8, 16,
32, 64): 4 cohorts of 128 cells, 512 warps a launch:

* ``split``: the kernel's profiling instance stamps the SM's cycle counter
  (``clock64``) at the boundaries of the phases of every step (``PHASES``)
  and sums them per cell.  Per cohort: cycles a step in each phase, idle
  skips a step, and the chain floor -- the phases the next pop depends on
  (``CHAIN_PHASES``), times K.  A stamp does not wait for a load in flight,
  so a load's latency shows in the phase that first uses its value.  The
  profiling instance is held bit-equal to the normal one on the same inputs.
* ``launches``: the grouped launch of all cohorts and each cohort alone,
  CUDA events over ``REPS`` launches, in turns (group, each cohort, group,
  each cohort).
* ``variants``: copies of the kernel's source with one change to the step's
  chain undone (``VARIANTS``; ``before`` undoes all of them), built beside
  the kernel under ``build/sched_split/`` and timed as grouped launches in
  turns with it, each with its own split; and ``-Xptxas -v`` of every
  ``NS`` body built alone (``ns1`` ... ``ns8``).
* ``grid``: one sweep of the grid through ``sweep_grid``, and the warm
  ``Experiment.run`` around it: ``fused_steps`` launches, wall seconds,
  the scheduler kernel's device milliseconds (``torch.profiler``) and the
  host's part of the grid split by ``cProfile`` into planning, uniforms,
  launches (the wrappers), the chunk loop's own time (where its early-exit
  reads wait for the card), result copies and the rest.  This part uses only
  what every version of the port has, so ``--turns DIR`` runs it on the port
  under ``DIR/src`` (another checkout, e.g. the parent commit unpacked) and
  on this tree in turns: DIR, this tree, this tree, DIR.

Run from the repository root on a machine with a CUDA device::

    PYTHONPATH=src python -m benchmarks.sched_split_torch [--turns DIR]

It prints one JSON object per part and writes them all to
``chiprun_out/sched_split.json``.  Without a CUDA device it raises.  The
module imports torch and the port, never jax or the reference package.
"""
from __future__ import annotations

import argparse
import cProfile
import ctypes
import itertools
import json
import os
import pstats
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.core.engines import run_trace
from repro_torch.core.experiment import Experiment, Scenario
from repro_torch.core.sim import replay_torch as rt
from repro_torch.kernels import _build
from repro_torch.kernels import sched_step as sk

from .kernels_bench_torch import card, card_state, cuda_ms

__all__ = ["PHASES", "CHAIN_PHASES", "VARIANTS", "NS_BODIES",
           "variant_sources", "cycles_to_us", "split_rows", "chain_floor_ms",
           "main_grid", "copy_states", "launch_group", "measure_split",
           "time_launches", "grid", "main"]

ROOT = Path(__file__).resolve().parents[1]
#: the main path's grid (``chip_smoke.py``): 128 latencies x 4 thread counts
N_LATS = 128
CANDS = (8, 16, 32, 64)
#: launches a timed turn averages over, and launches a split sums over
REPS = 8
SPLIT_LAUNCHES = 4

#: phases of one step, in program order (``sched_step.PROF_PHASES``)
PHASES = ("pop", "row_kd", "op_completion_se", "clock_grant",
          "prefetch_issue", "write")
#: the phases the next step's pop waits for: the popped thread's ring key
#: and ``now`` come out of them; the prefetch issue and the write phase feed
#: only later steps' reads, so they are off the chain in principle
CHAIN_PHASES = PHASES[:4]
_IDLE, _LAUNCH = len(PHASES), len(PHASES) + 1


def cycles_to_us(cycles, mhz):
    """SM cycles at ``mhz`` MHz as microseconds."""
    return cycles / mhz


def chain_floor_ms(chain_cycles_per_step, K, mhz):
    """K dependent steps of ``chain_cycles_per_step`` cycles, in ms."""
    return K * chain_cycles_per_step / (mhz * 1e3)


def split_rows(prof, widths, steps, mhz):
    """Per cohort, from the profiling buffer ``prof`` (cells x (phases,
    idle skips, launch cycles), cohorts' cells side by side, ``widths`` the
    cells of each) summed over ``steps`` steps: the mean cycles a step in
    each phase, their total, the chain's cycles (``CHAIN_PHASES``), the
    idle skips a step, the launch's cycles a step (state load and store
    included), and each cycle count as microseconds at ``mhz``."""
    prof = np.asarray(prof, dtype=np.float64)
    rows, off = [], 0
    for G in widths:
        block = prof[off:off + G]
        off += G
        per = block.sum(axis=0) / (G * steps)
        cyc = {p: float(per[i]) for i, p in enumerate(PHASES)}
        total = sum(cyc.values())
        chain = sum(cyc[p] for p in CHAIN_PHASES)
        rows.append({
            "cells": int(G),
            "cycles_per_step": cyc,
            "share": {p: c / total for p, c in cyc.items()},
            "total_cycles_per_step": total,
            "chain_cycles_per_step": chain,
            "launch_cycles_per_step": float(per[_LAUNCH]),
            "idle_skips_per_step": float(per[_IDLE]),
            "us_per_step": cycles_to_us(total, mhz),
            "chain_us_per_step": cycles_to_us(chain, mhz),
            "us_per_step_by_phase": {p: cycles_to_us(c, mhz)
                                     for p, c in cyc.items()},
        })
    return rows


# -- variants of the kernel's source ------------------------------------------

_SHFL_MIN = """  const unsigned hi = __reduce_min_sync(FULL, (unsigned)(v >> 32));
  const unsigned lo = __reduce_min_sync(
      FULL, (unsigned)(v >> 32) == hi ? (unsigned)v : 0xffffffffu);
  return ((unsigned long long)hi << 32) | lo;
"""
_SHFL_MIN_NEW = """#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = umin(v, __shfl_xor_sync(FULL, v, off));
  return v;
"""
_SLOT_IF = "    if (issue) {\n      unsigned long long sk =\n"
_SLOT_ALWAYS = "    {\n      unsigned long long sk =\n"
_BMEM_IF = """        pstart = fmax(pstart, pf_bw);
        pf_bw = pstart + a.cost_bmem;
"""
_BMEM_ALWAYS = """        pstart = fmax(pstart, pf_bw);
        if (issue) pf_bw = pstart + a.cost_bmem;
"""
_KD_CACHED = """    const double kind = s_kd[4 * tid];
    const double dur = s_kd[4 * tid + 1];
"""
_SE_AT = _KD_AT = "    const bool eoo = i2 >= end_f;\n"
_KD_GATHER = """    const double kind = __ldg(a.kd + 2 * (size_t)(int)(i2 - 1.0));
    const double dur = __ldg(a.kd + 2 * (size_t)(int)(i2 - 1.0) + 1);
"""
_SPAN_CACHED = """    const double i2 = s_kd[4 * tid + 2];
    const double end_f = s_kd[4 * tid + 3];
"""
_SPAN_AT = "    const double span = pr[1];\n"
_SPAN_UNPACK = """    const double end_f = floor(span * INV_SPAN);
    const double i2 = (span - end_f * SPAN) + 1.0;
"""
_MOD_DEV = "        clk_dev = io_dev;\n"
_MOD_DEV_OLD = "        clk_dev = io_rr % a.S;\n"
_MOD_CURSOR = ("    const int cursor = !eoo ? ci0 : (ci0 + 1 == a.n_trace ? 0 "
               ": ci0 + 1);\n")
_MOD_CURSOR_OLD = "    const int cursor = eoo ? (ci0 + 1) % a.n_trace : ci0;\n"
_WKEY = "              (w <= now_v) ? wkey[j] : d2b(stamp[j]);\n"
_WKEY_OLD = """              (w <= now_v) ? tag_enc(fmax(fmin(w, BIG), TE), t)
                           : d2b(stamp[j]);
"""
_SE_GATHER = """    se_s = __ldg(a.se + 2 * (size_t)ci0);
    se_e = __ldg(a.se + 2 * (size_t)ci0 + 1);
"""
_U_LANE = "  const double* u_row = a.u + cell + threadIdx.y;\n"
_U_UNIFORM = "  const double* u_row = a.u + cell;\n"
_DISPATCH = """  switch (co.NS) {
    case 1: run_cell<1, PROF>(a, co, g, smem); break;
    case 2: run_cell<2, PROF>(a, co, g, smem); break;
    case 4: run_cell<4, PROF>(a, co, g, smem); break;
    default: run_cell<8, PROF>(a, co, g, smem); break;
  }
"""


def _sub(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise ValueError(f"the kernel source has {src.count(old)} copies of "
                         f"{old[:60]!r}; the split needs exactly one")
    return src.replace(old, new)


def _shfl_min(src):
    return _sub(src, _SHFL_MIN, _SHFL_MIN_NEW)


def _span_unpack(src):
    return _sub(_sub(src, _SPAN_CACHED, ""), _SPAN_AT,
                _SPAN_AT + _SPAN_UNPACK)


def _wake_keys_each_pop(src):
    return _sub(src, _WKEY, _WKEY_OLD)


def _uniform_draw_loads(src):
    return _sub(src, _U_LANE, _U_UNIFORM)


def _modulo(src):
    return _sub(_sub(src, _MOD_DEV, _MOD_DEV_OLD), _MOD_CURSOR,
                _MOD_CURSOR_OLD)


def _slot_min_every_step(src):
    return _sub(_sub(src, _SLOT_IF, _SLOT_ALWAYS), _BMEM_IF, _BMEM_ALWAYS)


def _no_kd_cache(src):
    return _sub(_sub(src, _KD_CACHED, ""), _KD_AT, _KD_AT + _KD_GATHER)


def _no_se_ahead(src):
    return _sub(src, _SE_AT, _SE_AT + _SE_GATHER)


#: name -> edit of the kernel's source: the kernel as it is, and the kernel
#: with one change to the step's chain undone
VARIANTS = {
    "kernel": lambda s: s,
    "shfl_min": _shfl_min,            # 64-bit minima as 5 shuffle rounds
    "slot_min_every_step": _slot_min_every_step,  # not only to issue
    "no_kd_cache": _no_kd_cache,      # (kind, dur) gathered after the pop
    "no_se_ahead": _no_se_ahead,      # the cursor's se row at the op end
    "modulo": _modulo,                # io_rr % S and the cursor by modulo
    "span_unpack": _span_unpack,      # eoo from the span after the pop
    "wake_keys_each_pop": _wake_keys_each_pop,  # woken keys rebuilt a pop
    "uniform_draw_loads": _uniform_draw_loads,  # the draws' warp address
    "before": lambda s: _uniform_draw_loads(_wake_keys_each_pop(
        _span_unpack(_modulo(_no_se_ahead(_no_kd_cache(
            _slot_min_every_step(_shfl_min(s)))))))),
}
#: name -> edit that keeps one kernel body (``-Xptxas -v`` of each NS)
NS_BODIES = {f"ns{n}": (lambda s, n=n: _sub(
    s, _DISPATCH, f"  run_cell<{n}, PROF>(a, co, g, smem);\n"))
    for n in (1, 2, 4, 8)}


def variant_sources(src: str | None = None,
                    edits: dict | None = None) -> dict[str, str]:
    """``name -> source`` of every variant of ``sched_step.cu`` (``edits``
    defaults to :data:`VARIANTS`); raises ``ValueError`` if an edit no
    longer finds its place."""
    src = src if src is not None else \
        (_build.CSRC / "sched_step.cu").read_text()
    edits = VARIANTS if edits is None else edits
    return {name: edit(src) for name, edit in edits.items()}


def _build_variants(out: Path, sources: dict[str, str]):
    procs = {}
    for name, src in sources.items():
        d = out / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "sched_step.cu").write_text(src)
        shutil.copy(_build.CSRC / "token_clock.cuh", d / "token_clock.cuh")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I",
               str(d), "-o", str(d / "lib.so"), str(d / "sched_step.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    failed, notes = {}, {}
    for name, proc in procs.items():
        text, _ = proc.communicate()
        if proc.returncode:
            failed[name] = text[-2000:]
        notes[name] = ptxas_notes(text)
    if failed:
        raise RuntimeError(f"nvcc failed for the variants {failed}")
    return {name: out / name / "lib.so" for name in procs}, notes


def ptxas_notes(log: str) -> dict:
    """``{"normal"|"profiling": {"ptxas": ..., "spills": ...}}``: the
    registers line and the spills line of each instance of the kernel."""
    out, key = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            name = m.group(1)
            key = ("profiling" if "ILb1E" in name else "normal") \
                if "sched_step_kernel" in name else None
            continue
        if key is None:
            continue
        e = out.setdefault(key, {})
        if "spill stores" in ln:
            e["spills"] = ln.split(":", 1)[-1].strip()
        elif "Used" in ln and "registers" in ln:
            e["ptxas"] = ln.split(":", 1)[-1].strip()
    return out


# -- the main path's grid -----------------------------------------------------


def scenario(n_lats=N_LATS, cands=CANDS):
    doc = json.loads(
        (ROOT / "examples" / "scenarios" / "hash_index_2ssd.json").read_text())
    lats = [float(x) for x in np.round(np.linspace(0.1, 10.0, n_lats), 4)]
    doc.update(latencies_us=lats, thread_candidates=list(cands))
    return Scenario.from_dict(doc)


def main_grid(dev, n_lats=N_LATS, cands=CANDS):
    """The main path's scenario, its trace and its cohorts planned on
    ``dev`` (initial states, as ``sweep_grid`` starts them)."""
    sc = scenario(n_lats, cands)
    store, wl = Experiment(sc).build()
    tr = run_trace(store, wl, warmup_frac=sc.warmup_frac).trace
    cohorts = rt.plan_grid(sc.sim_config(), tr, sc.latencies_sec(),
                           sc.thread_candidates, n_ops=sc.n_ops, device=dev)
    return sc, tr, cohorts


def copy_states(states):
    """A copy of every plane of every state tuple."""
    return [tuple(p.clone() for p in s) for s in states]


def launch_group(cohorts, states, us, prof=None):
    """One grouped launch of ``cohorts`` in place on ``states`` (their
    uniform block ``us`` side by side); the profiling instance with
    ``prof``."""
    c0 = cohorts[0]
    parts = [(s, c.L_mem_g, c.nthr_g, c.warm_g)
             for s, c in zip(states, cohorts)]
    return sk.fused_steps_group(c0.substep, parts, us, c0.kd, c0.se, c0.arr,
                                c0.n_trace, c0.n_ops, c0.dyn, prof=prof)


def measure_split(cohorts, us, launches=SPLIT_LAUNCHES):
    """``(prof, bit_equal)``: the profiling instance's buffer summed over
    ``launches`` grouped launches from the cohorts' initial states (the
    uniform blocks ``us`` in turn), and whether its state planes equal the
    normal instance's after the same launches, bit for bit."""
    G = sum(c.G for c in cohorts)
    prof = torch.zeros(G, len(PHASES) + 2, dtype=torch.int64,
                       device=cohorts[0].state[2].device)
    a = copy_states([c.state for c in cohorts])
    b = copy_states([c.state for c in cohorts])
    for i in range(launches):
        launch_group(cohorts, a, us[i % len(us)], prof)
        launch_group(cohorts, b, us[i % len(us)])
    torch.cuda.synchronize()
    same = all(torch.equal(_bits(x), _bits(y))
               for sa, sb in zip(a, b) for x, y in zip(sa, sb))
    return prof.cpu().numpy(), same


def _bits(t):
    return t.view(torch.int64) if t.dtype == torch.float64 else t


def time_launches(cohorts, us, reps=REPS, rounds=2):
    """Milliseconds a launch of the grouped kernel (all cohorts) and of
    each cohort alone, CUDA events over ``reps`` launches, ``rounds`` turns
    (group, each cohort, group, ...).  Each timing continues its own copy
    of the states from a warm-up launch."""
    grp = copy_states([c.state for c in cohorts])
    alone = copy_states([c.state for c in cohorts])
    widths = np.cumsum([0] + [c.G for c in cohorts])
    cols = [[u[:, :, widths[i]:widths[i + 1]].contiguous() for u in us]
            for i in range(len(cohorts))]
    launch_group(cohorts, grp, us[0])
    for i, c in enumerate(cohorts):
        launch_group([c], [alone[i]], cols[i][0])
    out = {"group": [], "alone": [[] for _ in cohorts]}
    for _ in range(rounds):
        k = itertools.count()
        out["group"].append(cuda_ms(
            lambda: launch_group(cohorts, grp, us[next(k) % len(us)]), reps))
        for i, c in enumerate(cohorts):
            k = itertools.count()
            out["alone"][i].append(cuda_ms(
                lambda: launch_group([c], [alone[i]],
                                     cols[i][next(k) % len(us)]), reps))
    return out


# -- one sweep of the grid (any version of the port) -------------------------


def _host_split(prof: cProfile.Profile, wall_s: float) -> dict:
    """Seconds of the grid's host side by part, from ``cProfile``."""
    st = pstats.Stats(prof).stats
    cum, tot = {}, {}
    for (_, _, fn), (_, _, tt, ct, _) in st.items():
        cum[fn] = cum.get(fn, 0.0) + ct
        tot[fn] = tot.get(fn, 0.0) + tt
    parts = {
        "planning": cum.get("plan_grid", 0.0),
        "uniforms": cum.get("uniforms", 0.0) + cum.get("cohort_uniforms",
                                                       0.0),
        "launches": cum.get("fused_steps", 0.0) + cum.get(
            "fused_steps_group", 0.0),
        "chunk_loop_own": tot.get("_run_cohort", 0.0) + tot.get(
            "_run_cohorts", 0.0) + cum.get("<method 'tolist' of "
                                           "'torch._C.TensorBase' objects>",
                                           0.0),
        "result_copies": cum.get("<method 'cpu' of 'torch._C.TensorBase' "
                                 "objects>", 0.0),
    }
    parts["rest"] = wall_s - sum(parts.values())
    return parts


def grid(dev=None) -> dict:
    """One sweep of the main path's grid, warm: launches, wall seconds,
    the scheduler kernel's device ms and the host split (see the module
    docstring).  Uses only what every version of the port has."""
    dev = dev or torch.device("cuda", torch.cuda.current_device())
    sc = scenario()
    Experiment(sc).run()                      # warm-up: kernels, caches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    art = Experiment(sc).run()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    tr, cfg = art.trace_result.trace, sc.sim_config()
    args = (cfg, tr, sc.latencies_sec(), sc.thread_candidates)

    def sweep():
        g = rt.sweep_grid(*args, n_ops=sc.n_ops, device=dev)
        torch.cuda.synchronize()
        return g

    sk.fused_steps.launches = 0
    t0 = time.perf_counter()
    g = sweep()
    grid_s = time.perf_counter() - t0
    launches = sk.fused_steps.launches

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as p:
        t0 = time.perf_counter()
        sweep()
        prof_wall_s = time.perf_counter() - t0
    kern_ms = busy_ms = 0.0
    for ev in p.key_averages():
        # a user annotation's device range repeats its kernels' time
        if (getattr(ev, "device_type", None) != DeviceType.CUDA
                or getattr(ev, "is_user_annotation", False)):
            continue
        ms = getattr(ev, "self_device_time_total", 0.0) / 1e3
        busy_ms += ms
        if "sched_step_kernel" in ev.key:
            kern_ms += ms

    pr = cProfile.Profile()
    t0 = time.perf_counter()
    pr.enable()
    sweep()
    pr.disable()
    cprof_wall_s = time.perf_counter() - t0
    return {
        "port": str(Path(rt.__file__).resolve().parents[3]),
        "cells": int(g.throughput.size), "launches": launches,
        "grid_wall_s": grid_s, "run_wall_s": run_s,
        "kernel_ms": kern_ms, "device_busy_ms": busy_ms,
        "profiled_wall_s": prof_wall_s,
        "kernel_ms_per_launch": kern_ms / launches if launches else None,
        "host_share_of_grid": 1.0 - busy_ms / (prof_wall_s * 1e3),
        "cell_steps_run": int(g.cell_steps_run),
        "kernel_cell_steps_per_s": g.cell_steps_run / (kern_ms * 1e-3)
        if kern_ms else None,
        "host_split_s": _host_split(pr, cprof_wall_s),
        "cprofile_wall_s": cprof_wall_s,
        "throughput_sum": float(g.throughput.sum()),
    }


def turns(other: Path) -> list[dict]:
    """``grid()`` on the port under ``other/src`` and on this tree in turns
    (other, this, this, other), each in a process of its own."""
    out = []
    for src in (other / "src", ROOT / "src", ROOT / "src", other / "src"):
        env = dict(os.environ, PYTHONPATH=str(src))
        run = subprocess.run(
            [sys.executable, "-m", "benchmarks.sched_split_torch",
             "--grid-only"], capture_output=True, text=True, env=env,
            cwd=str(ROOT), timeout=900)
        if run.returncode != 0:
            raise RuntimeError(f"grid turn on {src} failed:\n"
                               f"{run.stderr[-3000:]}")
        out.append(json.loads(run.stdout.strip().splitlines()[-1]))
    return out


def _require_card():
    if not torch.cuda.is_available():
        raise RuntimeError(
            "sched_split_torch: no CUDA device is available; the split "
            "measures the port's kernel on an NVIDIA GPU and has no CPU "
            "fallback")
    return torch.device("cuda", torch.cuda.current_device())


def _emit(rows, name, **fields):
    line = {"part": name, **fields}
    rows.append(line)
    print(json.dumps(line), flush=True)


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--turns", type=Path, default=None,
                    help="a second checkout whose src/ runs the grid part "
                         "in turns with this tree's")
    ap.add_argument("--grid-only", action="store_true",
                    help="print the grid part of this process's port only")
    args = ap.parse_args(argv)
    dev = _require_card()
    if args.grid_only:
        print(json.dumps(grid(dev)), flush=True)
        return []
    name, limit = card()
    rows = []
    _emit(rows, "card", card=name, power_limit=limit)
    sc, tr, cohorts = main_grid(dev)
    us = [rt.cohort_uniforms(cohorts, ck) for ck in range(SPLIT_LAUNCHES)]
    widths = [c.G for c in cohorts]
    K = us[0].shape[0]

    libs, notes = _build_variants(ROOT / "build" / "sched_split",
                                  {**variant_sources(),
                                   **variant_sources(edits=NS_BODIES)})
    _emit(rows, "ptxas", by_variant=notes)
    saved = _build._LIBS.get("sched_step")
    try:
        loaded = {v: ctypes.CDLL(str(libs[v])) for v in VARIANTS}
        splits, times = {}, {v: [] for v in VARIANTS}
        for v in VARIANTS:                     # warm-up of each library
            _build._LIBS["sched_step"] = loaded[v]
            launch_group(cohorts, copy_states([c.state for c in cohorts]),
                         us[0])
        for rnd in range(2):
            order = list(VARIANTS) if rnd == 0 else list(VARIANTS)[::-1]
            for v in order:
                _build._LIBS["sched_step"] = loaded[v]
                st = copy_states([c.state for c in cohorts])
                k = itertools.count()
                times[v].append(cuda_ms(
                    lambda: launch_group(cohorts, st, us[next(k) % len(us)]),
                    REPS))
        for v in VARIANTS:
            _build._LIBS["sched_step"] = loaded[v]
            prof, same = measure_split(cohorts, us)
            mhz = card_state()["sm_mhz"]
            splits[v] = {"bit_equal_to_normal_instance": same,
                         "sm_mhz": mhz,
                         "cohorts": split_rows(prof, widths,
                                               SPLIT_LAUNCHES * K, mhz)}
    finally:
        if saved is None:
            _build._LIBS.pop("sched_step", None)
        else:
            _build._LIBS["sched_step"] = saved
    for v in VARIANTS:
        _emit(rows, "variant", variant=v, group_ms=times[v],
              us_per_step=[t * 1e3 / K for t in times[v]],
              split=splits[v])
    launches = time_launches(cohorts, us)
    _emit(rows, "launches", K=K, cohorts=[
        {"T_max": c.T_max, "G": c.G, "NS": sk.slot_count(
            c.state[2].shape[1])} for c in cohorts],
        ms=launches, card_state=card_state())
    if args.turns is not None:
        _emit(rows, "grid_turns", order=["other", "this", "this", "other"],
              runs=turns(args.turns.resolve()))
    else:
        _emit(rows, "grid", **grid(dev))
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "sched_split.json").write_text(json.dumps(
        {"card": name, "power_limit": limit, "rows": rows}, indent=1))
    return rows


if __name__ == "__main__":
    main()
