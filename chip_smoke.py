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
  * the sharded fleet: the same scenario and grid on a 4-node cluster (one
    grid a node through the fused kernel), checked against the host loop's
    fleet and the trivial 1-node fleet against the plain sweep; the torch
    cluster bench (``benchmarks.cluster_bench_torch``) at full size beside
    the host loop; and the conformance harness (the checked-in corpus and
    a fixed range of fuzz seeds, every check);
  * serving: ``ServeEngine`` with qwen2.5-3b at full width (weights drawn on
    the card from ``--seed``) answering 8 requests, every decode step's
    attention through the paged CUDA kernel, two of the requests checked
    against the dense decode path teacher-forced on the served tokens;
  * the kernel-ops entry point: ``benchmarks.kernels_bench_torch`` runs
    flash attention, paged decode attention and wkv6 through
    ``repro_torch.kernels.ops`` at the reference bench's full-width shapes
    (llava-next-mistral-7b's attention heads, rwkv6-3b's WKV heads).
  * the model zoo through ``repro_torch.zoo.get_api``: every architecture's
    smoke config on the card against the CPU, then rwkv6-3b,
    deepseek-moe-16b, qwen2-moe-a2.7b, zamba2-7b, whisper-small and
    llava-next-mistral-7b at full width (weights drawn on the card from
    ``--seed``), a forward and 64 teacher-forced decode steps each, decode
    held against forward; the wkv6 kernel timed beside the model's
    ``wkv_chunked`` at rwkv6-3b's own recurrence inputs.

  * training: qwen2.5-3b at full width and depth trained for 6 AdamW steps
    of 2 x 2048 tokens through ``repro_torch.train.make_train_step``
    (per-layer remat, the blockwise attention's custom backward, the state
    donated leaf by leaf), the backward held against plain autograd at that
    layer's shape; then the reference's learning test on the card,
    ``examples/train_100m_torch.py`` (120 steps, its re-run, and a resume
    check bit for bit under deterministic algorithms).

  * the dry run (``python -m repro_torch.launch.dryrun``): qwen2.5-3b's
    production cells on the (16, 16) and (2, 16, 16) meshes counted under
    ``FakeTensorMode`` on fake process groups, and the cell at the training
    shape on a 1x1 mesh held against one real step on the card (FLOPs
    equal, predicted memory against the measured peak).

  * the system's own entry points: ``python -m benchmarks.run_torch``
    (the scenario suite, one scenario and ``--engine lsm --cores 4``, held
    cell by cell against the host loop; then every paper figure and the
    kernels' rows, the figures' grid cells held against the loop's), the
    grid bench (``benchmarks.torch_grid_bench``, every suite at the
    reference's sizes), the tail bench (``FULL``, beside the host loop)
    and the kvstore, serving and quickstart examples
    (``examples/*_torch.py``).

It times the kernels and prints one JSON object per phase.  The last line is
``{"ok": true, "device": {...}}``.  Any failing phase exits non-zero; there
is no CPU fallback: without a CUDA device the script fails.
"""
import argparse
import atexit
import contextlib
import functools
import hashlib
import importlib.util
import inspect
import io
import json
import math
import numbers
import os
import re
import shutil
import signal
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
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
from repro_torch.core import conformance
from repro_torch.core.cluster import sweep_cluster
from repro_torch.core.conformance import grid_tol, tail_tol
from repro_torch.core.engines import run_trace
from repro_torch.core.experiment import Experiment, RunOptions, Scenario
from repro_torch.core.sim import generate_arrivals, simulate_compiled
from repro_torch.core.sim import replay_torch as rt
from repro_torch.core.sim import sweep as sweep_mod
from repro_torch import zoo
from repro_torch.kernels import _build
from repro_torch.kernels import ops
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import paged_kv_gather as pk
from repro_torch.kernels import sched_step as sk
from repro_torch.kernels import token_clock as tc
from repro_torch.kernels import wkv6 as wk
from repro_torch.kernels.ref import (flash_attention_ref,
                                     paged_decode_attention_ref, wkv6_ref)
from repro_torch.configs import smoke_config
from repro_torch.models import layers, rwkv6
from repro_torch.models import transformer as tf
from repro_torch.models import whisper as wh
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.configs.base import Shape
from repro_torch.data.pipeline import DataConfig, prefetch, synthetic_batches
from repro_torch.roofline.analysis import (active_params, count_params,
                                           model_flops)
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.train_step import (TrainHParams, init_train_state,
                                          make_train_step)
from repro_torch.tree import get_leaf, leaf_paths

from benchmarks import cluster_bench_torch as cbench
from benchmarks import kernels_bench_torch as kbench
from benchmarks import paper_figs_torch as pfigs
from benchmarks import run_torch
from benchmarks import tail_latency_bench_torch as tbench
from benchmarks import torch_grid_bench as gbench
from benchmarks import sched_split_torch as ssplit
from benchmarks import token_clock_bench_torch as tcb
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

# The model zoo (``model_families``): each of the six archs of the families
# beside the dense transformer at its published width and depth, nothing
# cut, one at a time, weights drawn on the card from --seed.  B 2 x S 64
# tokens (llava-next with its 2880 patches in front, whisper with its 1500
# frames), then 64 teacher-forced decode steps held against the forward at
# the reference's decode-vs-forward bound (MoE at capacity factor 64, as
# the reference's parity test); llava's decode sees the text alone, so it
# has no parity check.
FAMILY_ARCHS = ("rwkv6-3b", "deepseek-moe-16b", "qwen2-moe-a2.7b",
                "zamba2-7b", "whisper-small", "llava-next-mistral-7b")
FAMILY_B, FAMILY_S = 2, 64
NO_PARITY = ("llava-next-mistral-7b",)
# ... and at every arch's smoke config: the card's logits against the
# port's CPU run on the same parameters (tests/_torch_kernel_cases.py's
# MODEL_TOL), and the reference's parity protocol on the card (10 steps)
# for its seven archs.
SMOKE_PARITY_ARCHS = ("qwen2.5-3b", "starcoder2-3b", "deepseek-moe-16b",
                      "zamba2-7b", "rwkv6-3b", "whisper-small",
                      "qwen2-moe-a2.7b")
# rwkv6-3b's own recurrence inputs for the wkv6 timing: layer 0 of the
# forward above, and of a B 8 x S 4096 token batch.
WKV_MODEL_BIG = (8, 4096)

# Training (``train_path``): qwen2.5-3b at its published width and depth
# (36 layers, d 2048, 16/2 heads of 128, d_ff 11008, vocab 151 936, tied
# embeddings; 3.09 B parameters, 6.17 GB in bfloat16), nothing cut, random
# initial weights drawn on the card from --seed; AdamW with float32
# moments, per-layer remat, 6 steps of B 2 x S 2048 synthetic tokens.  S
# 2048 > attn_block_kv 1024 puts every layer's attention through the
# blockwise forward and its custom backward.  warmup 1: with the default 200
# the first steps' lr (0, then 1.5e-6) is below half a bfloat16 step of most
# weights and nothing would move.
TRAIN_ARCH = "qwen2.5-3b"
TRAIN_B, TRAIN_S = 2, 2048
TRAIN_HP = dict(peak_lr=3e-4, warmup=1, total_steps=6)
TRAIN_STEPS = 6
# The dry run's production cells (``python -m repro_torch.launch.dryrun``, one
# process a mesh, run side by side) and the band the 1x1 cell's predicted
# per-device memory must fall in, as a multiple of the measured peak
DRYRUN_CELLS = (("single", "train_4k,prefill_32k,decode_32k"),
                ("multi", "train_4k"))
DRYRUN_MEM_BAND = (0.8, 1.25)
# The blockwise backward held against plain autograd of the same forward at
# one layer of that model: B 2, S 2048, Hq 16, Hkv 2, D 128, causal, 1024-key
# blocks.
FLASH_BWD_SHAPE = (TRAIN_B, TRAIN_S, 16, 2, 128)
# The training example (``train_example``): examples/train_100m_torch.py's
# own run at the reference example's sizes, checkpoints every 50 steps.
# The reference's learning criterion (tests/test_train.py: the mean of the
# last 10 losses below the mean of the first 10 by more than 1.0) belongs to
# its smoke run (qwen2.5-3b's smoke config, B 16 x S 48, 120 steps), which
# runs here on the card as stated.  The reference's own example at these
# arguments does not meet it (ROADMAP.md C26): the means of its first and
# last 10 losses are 9.5001 and 9.0504 (examples/train_100m.py --steps 120
# --batch 8 --seq 256, run on a CPU with the losses of every step kept).  The port's example is held to that run instead: its last-10
# mean within EXAMPLE_LAST10_TOL of the reference's, and below its own
# first-10 mean.
EXAMPLE_ARGS = ("--steps", "120", "--batch", "8", "--seq", "256")
EXAMPLE_RESUME_STEPS = 3
EXAMPLE_REF_LAST10 = 9.050448989868164   # first 10: 9.500146675109864
EXAMPLE_LAST10_TOL = 0.05
LEARNS_HP = dict(peak_lr=1e-3, warmup=10, total_steps=120)
LEARNS_BS = (16, 48)

OUT_DIR = ROOT / "chiprun_out"
PHASES = []
#: the run's start: each phase line carries its seconds since (``t_s``)
T_START = time.perf_counter()


def emit(name, **fields):
    line = {"phase": name, **fields,
            "t_s": time.perf_counter() - T_START}
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
    tc.token_clock_update.launches_by_instance = dict.fromkeys(
        tc.INSTANCES, 0)


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
    # the libraries' SASS, disassembled side by side
    with ThreadPoolExecutor(4) as pool:
        list(pool.map(sass_text, ("flash_attention", "paged_kv_gather",
                                  "sched_step", "wkv6")))
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


@functools.lru_cache(maxsize=None)
def sass_text(lib):
    """One built library's SASS (``cuobjdump -sass``), or None where the
    toolkit has no ``cuobjdump`` or it fails."""
    tool = Path(_build._nvcc()).parent / "cuobjdump"
    if not tool.exists():
        return None
    sass = subprocess.run([str(tool), "-sass", str(_build._lib_path(lib))],
                          capture_output=True, text=True, timeout=300)
    return sass.stdout if sass.returncode == 0 else None


def sass_count(lib, func_key, opcode):
    """Count of ``opcode`` instructions per kernel of one built library's
    SASS, or None where there is none (:func:`sass_text`)."""
    text = sass_text(lib)
    if text is None:
        return None
    counts, key = {}, None
    for ln in text.splitlines():
        m = re.search(r"Function : (\w+)", ln)
        if m:
            key = func_key(m.group(1))
            if key:
                counts[key] = 0
        elif key and re.search(rf"\b{opcode}\b", ln):
            counts[key] += 1
    return counts


#: the token-clock kernel's instances held against the plain version:
#: (S, mask dtype, instance); the generic one also at S 3 and 64 and with
#: an int32 mask (read as it is: no cast launch)
TOKEN_CLOCK_CASES = ((1, torch.bool, "s1"), (2, torch.bool, "s2"),
                     (4, torch.bool, "s4"), (8, torch.bool, "s8"),
                     (3, torch.bool, "generic"), (64, torch.uint8, "generic"),
                     (2, torch.int32, "generic"))
TOKEN_CLOCK_SPACINGS = ((1 / 250e3, 0.0), (1 / 250e3, 1024 / 400e6),
                        (0.0, 1024 / 400e6), (0.0, 0.0))


def start_token_clock_count():
    """``benchmarks.token_clock_bench_torch --count`` at its ``SHAPE`` (the
    main path's widest cohort's planes) in a process of its own,
    started now (it times nothing, so it runs beside the conformance
    phase); :func:`phase_token_clock` reads it."""
    return start_module("benchmarks.token_clock_bench_torch", "--count",
                        timeout=600)


def phase_token_clock(G, S, plain_step_wall_s, count_run):
    """The standalone token-clock kernel: every instance bit-equal to its
    plain version on planes of ``G`` cells (each clock on and off), one
    launch a call; then at the main path's plane shape ``(G, S)`` its device
    time a call (behind a sleep), its host time a call, an empty kernel's
    (the launch floor) and the plain version's, and its device kernels a
    call by the profiler, which must be one (``count_run``, started by
    :func:`start_token_clock_count`), beside its bound and the plain-step
    path's wall time."""
    worst, by_case = 0.0, {}
    for i, (s, dt, want_inst) in enumerate(TOKEN_CLOCK_CASES):
        for j, (inv_r, cost) in enumerate(TOKEN_CLOCK_SPACINGS):
            args = (*tcb.planes(G, s, DEV, seed=101 + 7 * i + j,
                                mask_dtype=dt), inv_r, cost)
            before = dict(tc.token_clock_update.launches_by_instance)
            got = tc.token_clock_update(*args)
            want = tc.token_clock_update_ref(*args)
            torch.cuda.synchronize()
            ran = [k for k, v in tc.token_clock_update.launches_by_instance
                   .items() if v != before[k]]
            if ran != [want_inst]:
                fail(f"token_clock_update at S={s} ({dt}) ran {ran}, "
                     f"expected one launch of {want_inst}")
            for a, b in zip(got, want):
                if not torch.equal(a.view(torch.int64), b.view(torch.int64)):
                    worst = max(worst, float((a - b).abs().max()))
        by_case[f"S{s}-{str(dt).split('.')[-1]}"] = want_inst
    if worst != 0.0:
        fail(f"token_clock_update disagrees with its plain version "
             f"(max abs err {worst})")
    # kernels a call counted in a fresh process (``count_run``): by now this
    # one's profiler records no kernels, and a cast launch must show
    out, _, count_s = count_run()
    m = json.loads(out.strip().splitlines()[-1])
    if tuple(m["shape"]) != (G, S):
        fail(f"the token-clock count ran at {m['shape']}, the main path's "
             f"planes are {(G, S)}")
    if m["launches_a_call"] != 1 or m["kernels_per_call"] != 1:
        fail(f"token_clock_update is not one kernel launch a call: {m}")
    m.update(tcb.timings(G, S))
    # bytes: submit + devmask (bool) + tok + bw in; svc + tok + bw out
    nbytes = 8 * G + G * S + 2 * 8 * G * S + 8 * G + 2 * 8 * G * S
    flops = G * (4 + 2 * S)          # two max, two add, S-term mask sums
    b_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    b_ops = flops / F64_FLOP_PER_S * 1e3
    return dict(
        name="token_clock.token_clock_update", route="cuda",
        source="src/repro_torch/kernels/csrc/token_clock.cu",
        replaces="src/repro/kernels/token_clock.py:69",
        max_abs_err=worst, ms=m["device_us"] * 1e-3,
        plain_ms=m["plain_device_us"] * 1e-3,
        bound_ms=max(b_bytes, b_ops),
        bound_by="bytes" if b_bytes >= b_ops else "operations",
        library_ms=None, shape=[G, S], tolerance="bit-equal",
        instance=m["instance"], instances_checked=by_case,
        host_us=m["host_us"], host_us_windows=m["host_us_windows"],
        floor_device_us=m["floor_device_us"],
        floor_host_us=m["floor_host_us"],
        plain_host_us=m["plain_host_us"],
        kernels_per_call=m["kernels_per_call"], count_s=count_s,
        device_over_floor=m["device_us"] / m["floor_device_us"],
        plain_step_wall_s=plain_step_wall_s,
        timing="device: CUDA events around one call behind a GPU sleep, "
               "mean of 200; host: perf_counter over 1000 calls, no sync, "
               "the least of 5 windows; floor: an empty kernel with the "
               "same grid")


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
    for a, b in zip(art_plain.rows, art.rows, strict=True):
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
         launches_by_instance=dict(
             tc.token_clock_update.launches_by_instance),
         bit_identical_to_fused_rows=True)
    return launches, wall_s


def phase_agreement(sc, art):
    """A handful of main-path cells next to the host interpreter loop, and an
    open-loop run (Poisson arrivals at about half the closed-loop
    throughput, percentiles on) so the arrival and histogram planes run on
    the card too."""
    tr = art.trace_result.trace
    cfg = sc.sim_config()
    tol = grid_tol(sc.n_ops)
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


# -- the sharded fleet and the conformance harness -----------------------------

#: The fleet of ``tests/test_cluster.py``'s ``FLEET``: 4 nodes behind a
#: 5 us router hop, hash partition, replication 2 with spread reads.
FLEET = {"n_nodes": 4, "partition": "hash", "L_route_us": 5.0,
         "replication": 2, "replica_policy": "spread"}
#: Conformance on the card: the checked-in corpus, then this fixed range of
#: fuzz seeds, every check (about a minute on an H100: the kernel check's
#: plain step takes most of it).
FUZZ_SEEDS = range(0, 6)


class NodeGrids:
    """Records every ``sweep_grid`` call of a fleet run (one a node): its
    config, host wall seconds, ``fused_steps`` launches and the result.
    Installed over ``replay_torch.sweep_grid`` while a window runs."""

    def __init__(self):
        self.calls = []
        self._real = rt.sweep_grid

    def __enter__(self):
        def record(cfg, trace, *a, **kw):
            before = sk.fused_steps.launches
            t0 = time.perf_counter()
            g = self._real(cfg, trace, *a, **kw)
            torch.cuda.synchronize()
            self.calls.append(dict(
                cfg=cfg, wall_s=time.perf_counter() - t0, grid=g,
                launches=sk.fused_steps.launches - before))
            return g
        rt.sweep_grid = record
        return self

    def __exit__(self, *exc):
        rt.sweep_grid = self._real


def fleet_kernel_ms(sc):
    """Device ms of the scheduler kernel and of everything on the card in
    one more fleet run, and its wall seconds (``torch.profiler``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as p:
        t0 = time.perf_counter()
        Experiment(sc).run()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    kern_ms = busy_ms = 0.0
    for ev in p.key_averages():
        if getattr(ev, "device_type", None) != DeviceType.CUDA:
            continue
        ms = getattr(ev, "self_device_time_total", 0.0) / 1e3
        busy_ms += ms
        if "sched_step_kernel" in ev.key:
            kern_ms += ms
    return kern_ms, busy_ms, wall_s


def _rows_equal(a, b):
    return all(x.per_thread == y.per_thread and x.n_threads == y.n_threads
               and x.throughput == y.throughput and x.nodes == y.nodes
               for x, y in zip(a.rows, b.rows)) and len(a.rows) == len(b.rows)


def phase_cluster_path(art_main):
    """The sharded fleet at full size, nothing cut: the main path's scenario
    and axes (128 latencies x threads 8/16/32/64) on the 4-node ``FLEET``,
    4 x 512 node-cells, through ``Experiment.run`` with default options
    (backend torch, device cuda): one ``sweep_grid`` a node.  Warm-up, then
    a counted run; the counts are set to 0 just before it and read just
    after."""
    sc = scenario(N_LATS, CANDS, cluster=dict(FLEET))
    t0 = time.perf_counter()
    warm = Experiment(sc).run()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with NodeGrids() as nodes:
        t0 = time.perf_counter()
        art = Experiment(sc).run()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    launches = counts()
    peak = torch.cuda.max_memory_allocated()
    calls = nodes.calls
    if launches["fused_steps"] <= 0:
        fail("kernel fused_steps was not launched on the cluster path")
    if launches["token_clock_update"] != 0:
        fail("the cluster path launched the standalone token-clock kernel")
    n_active = sum(1 for n in art.rows[0].nodes if n["n_ops"])
    if len(calls) != n_active:
        fail(f"{len(calls)} node grids for {n_active} active nodes")
    max_launches = sum(c["grid"].steps // rt._RNG_CHUNK for c in calls)
    if launches["fused_steps"] > max_launches:
        fail(f"the cluster path launched fused_steps "
             f"{launches['fused_steps']} times for node grids of "
             f"{max_launches} chunks in all")
    if not _rows_equal(art, warm):
        fail("two runs of the fleet are not bit-identical")
    # the fleet is the sum of its nodes, cell by cell
    for li, row in enumerate(art.rows):
        for ci, c in enumerate(CANDS):
            total = sum(float(n["grid"].throughput[li, ci]) for n in calls)
            if dict(row.per_thread)[c] != total:
                fail(f"fleet per_thread at L={row.L_us}us, {c} threads is "
                     f"not the sum of its nodes")
        if not (math.isfinite(row.throughput) and row.throughput > 0):
            fail(f"fleet throughput {row.throughput} at L={row.L_us}us")
        shares = sum(n["share"] for n in row.nodes)
        if abs(shares - 1.0) > 1e-12 or \
                sum(n["n_ops"] for n in row.nodes) != sc.n_ops:
            fail(f"node shares sum to {shares}, node ops to "
                 f"{sum(n['n_ops'] for n in row.nodes)}")

    # six cells against the host loop's fleet, under the contract's bound
    contract = conformance.CONTRACTS["cluster-torch-vs-loop"]
    tol = grid_tol(sc.n_ops, base=contract.throughput_tol,
                   ref_ops=contract.ref_ops)
    store, wl = Experiment(sc).build()
    n_warm = int(len(wl) * sc.warmup_frac)
    tr, cfg, spec = art.trace_result.trace, sc.sim_config(), sc.cluster_spec()
    lats_s = sc.latencies_sec()
    n = len(lats_s)
    cells, worst = [], 0.0
    t0 = time.perf_counter()
    for li, cj in ((0, 0), (n // 4, 1), (n // 2, 2), (3 * n // 4, 3),
                   (n - 1, 3), (n - 1, 0)):
        cand = CANDS[cj % len(CANDS)]
        (pt,) = sweep_cluster(cfg, tr, wl.keys[n_warm:],
                              wl.is_write[n_warm:], spec, [lats_s[li]],
                              [cand], n_ops=sc.n_ops, backend="loop")
        got, ref = dict(art.rows[li].per_thread)[cand], pt.per_thread[cand]
        rel = abs(got - ref) / ref
        worst = max(worst, rel)
        cells.append({"L_us": sc.latencies_us[li], "threads": cand,
                      "card": got, "host_loop": ref, "rel": rel})
    loop_s = time.perf_counter() - t0
    if worst > tol:
        fail(f"fleet on the card vs the host loop: worst cell {worst:.4%} "
             f"> {tol:.4%} (cluster-torch-vs-loop)")

    # trivial-cluster: a 1-node fleet is the main path's single-host sweep
    triv = Experiment(scenario(N_LATS, CANDS, cluster={"n_nodes": 1})).run()
    for a, b in zip(triv.rows, art_main.rows):
        if (a.per_thread != b.per_thread or a.n_threads != b.n_threads
                or a.throughput != b.throughput):
            fail(f"the trivial 1-node fleet differs from the plain sweep at "
                 f"L={a.L_us}us (trivial-cluster)")

    kern_ms, busy_ms, prof_wall_s = fleet_kernel_ms(sc)
    node_rows = [{"node": k, "seed": c["cfg"].seed,
                  "n_ops": int(c["grid"].ops), "wall_s": c["wall_s"],
                  "launches": c["launches"],
                  "chunks": c["grid"].steps // rt._RNG_CHUNK,
                  "cell_steps_run": int(c["grid"].cell_steps_run)}
                 for k, c in enumerate(calls)]
    grids_s = sum(c["wall_s"] for c in calls)
    emit("cluster_path", scenario=sc.display_name, cluster=FLEET,
         node_cells=int(sum(c["grid"].throughput.size for c in calls)),
         n_latencies=N_LATS, thread_candidates=list(CANDS), n_ops=sc.n_ops,
         cut="none", warmup_wall_s=warm_s, wall_s=wall_s,
         node_grids_wall_s=grids_s, host_outside_grids_s=wall_s - grids_s,
         nodes=node_rows, launches=launches, max_launches=max_launches,
         peak_device_bytes=int(peak), kernel_ms=kern_ms,
         device_busy_ms=busy_ms, profiled_wall_s=prof_wall_s,
         device_idle_share=1.0 - busy_ms / (prof_wall_s * 1e3),
         shares=[n_["share"] for n_ in art.rows[0].nodes],
         node_ops=[n_["n_ops"] for n_ in art.rows[0].nodes],
         best_threads_first_last=[art.rows[0].n_threads,
                                  art.rows[-1].n_threads],
         vs_host_loop={"tolerance": tol, "worst_rel": worst, "cells": cells,
                       "loop_s": loop_s},
         trivial_cluster_bit_identical=True, bit_identical_runs=True)
    return launches


def _bench_doc_check(doc, path):
    path.write_text(json.dumps(doc, indent=2) + "\n")
    res = subprocess.run([sys.executable, str(ROOT / "tools" /
                                              "check_bench.py"), str(path)],
                         capture_output=True, text=True, timeout=120)
    if res.returncode != 0:
        fail(f"tools/check_bench.py refused {path.name}: "
             f"{res.stdout}{res.stderr}")
    return res.stdout.strip().splitlines()


def phase_cluster_bench():
    """``benchmarks/cluster_bench_torch.py`` at ``FULL_SIZE`` on the card
    (its four scenarios: a capacity probe, then Poisson at 0.7 of it with
    percentiles), validated by ``tools/check_bench.py``; then the host loop
    on the same scenarios, offered the same loads.  Probed capacity and
    open-loop fleet throughput (the sum of the node rates) are held to
    ``cluster-torch-vs-loop``, node
    shares must be identical; p50 / p99 are printed beside the contract's
    tail bound (a miss is printed with its figure, not hidden)."""
    reset_counts()
    with NodeGrids() as nodes:
        t0 = time.perf_counter()
        doc = cbench.run(sorted(cbench.SCENARIOS), False, "torch", DEV)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    launches = counts()
    if launches["fused_steps"] <= 0 or launches["token_clock_update"]:
        fail(f"cluster_bench launches: {launches}")
    # degraded_node runs twice (probe, open loop): each time the grid of
    # node 1 (seed + 1) is the only one stepped with has_degrade
    flags = [rt._make_flags(c["cfg"])["has_degrade"] for c in nodes.calls]
    seed1 = cbench.SCENARIOS["degraded_node"](False).seed + 1
    if sum(flags) != 2 or any(c["cfg"].seed != seed1 for c, f in
                              zip(nodes.calls, flags) if f):
        fail(f"degraded_node: has_degrade on {sum(flags)} node grids, not "
             f"node 1's twice")
    checked = _bench_doc_check(doc, OUT_DIR / "cluster_bench_torch.json")
    offer_of = {k: v["capacity"] for k, v in doc["summary"].items()}
    t0 = time.perf_counter()
    loop = cbench.run(sorted(cbench.SCENARIOS), False, "loop",
                      offer_of=offer_of)
    loop_s = time.perf_counter() - t0
    _bench_doc_check(loop, OUT_DIR / "cluster_bench_loop.json")

    contract = conformance.CONTRACTS["cluster-torch-vs-loop"]
    n_ops = cbench.FULL_SIZE["n_ops"]
    thr_tol = grid_tol(n_ops, base=contract.throughput_tol,
                       ref_ops=contract.ref_ops)
    tails = {f: tail_tol(n_ops, base=getattr(contract, f"{f}_tol"),
                         ref_ops=contract.tail_ref_ops)
             for f in ("p50", "p99")}
    rows, tail_misses = [], []
    for name in sorted(cbench.SCENARIOS):
        cap_t = doc["summary"][name]["capacity"]
        cap_l = loop["summary"][name]["capacity"]
        rel = abs(cap_t - cap_l) / cap_l
        if rel > thr_tol:
            fail(f"{name}: probed fleet capacity {cap_t} vs host loop "
                 f"{cap_l} ({rel:.4%} > {thr_tol:.4%})")
        for et, el in zip((e for e in doc["entries"] if e["name"] == name),
                          (e for e in loop["entries"] if e["name"] == name)):
            if [n_["share"] for n_ in et["nodes"]] != \
                    [n_["share"] for n_ in el["nodes"]]:
                fail(f"{name} L={et['L_us']}us: node shares differ from the "
                     f"host loop's")
            # the contract's fleet throughput: the sum of the node rates
            # (the bench's achieved_load, ops over the slowest node's
            # window, is printed beside it)
            thr_t = sum(n_["achieved_load"] for n_ in et["nodes"])
            thr_l = sum(n_["achieved_load"] for n_ in el["nodes"])
            rel_t = abs(thr_t - thr_l) / thr_l
            if rel_t > thr_tol:
                fail(f"{name} L={et['L_us']}us: fleet throughput {thr_t} vs "
                     f"host loop {thr_l} ({rel_t:.4%} > {thr_tol:.4%})")
            row = {"name": name, "L_us": et["L_us"],
                   "n_threads": et["n_threads"],
                   "offered_load": et["offered_load"],
                   "fleet_throughput_card": thr_t,
                   "fleet_throughput_loop": thr_l, "throughput_rel": rel_t,
                   "achieved_card": et["achieved_load"],
                   "achieved_loop": el["achieved_load"],
                   "achieved_rel": abs(et["achieved_load"]
                                       - el["achieved_load"])
                   / el["achieved_load"]}
            for f in ("p50", "p99"):
                a, b = el[f"{f}_us"], et[f"{f}_us"]
                r = abs(a - b) / max(a, b)
                row.update({f"{f}_card_us": b, f"{f}_loop_us": a,
                            f"{f}_rel": r, f"{f}_within": r <= tails[f]})
                if r > tails[f]:
                    tail_misses.append(f"{name} L={et['L_us']}us {f}: card "
                                       f"{b} vs loop {a}, rel {r:.3f} > "
                                       f"{tails[f]:.3f}")
            rows.append(row)
        rows[-1]["capacity_card"], rows[-1]["capacity_loop"] = cap_t, cap_l
    emit("cluster_bench", wall_s=wall_s, loop_wall_s=loop_s,
         launches=launches, node_grids=len(nodes.calls),
         scenario_wall_s={k: v["wall_s"] for k, v in doc["summary"].items()},
         check_bench=checked, throughput_tol=thr_tol, tail_tol=tails,
         rows=rows, tail_misses=tail_misses,
         tail_note="a tail miss is printed with its figure and filed in "
                   "ROADMAP Queue C beside C11; the bound is not widened")
    return launches


def phase_conformance():
    """The conformance harness on the card: the checked-in corpus
    (``examples/conformance/``) through every check (``compiled``,
    ``torch``, ``kernel``), then fuzz seeds ``FUZZ_SEEDS``, every check.
    Any failure is fatal, save the corpus's one recorded contract miss
    (``_torch_kernel_cases.CORPUS_KNOWN_MISSES``, ROADMAP C14), which must
    recur with its exact figure."""
    corpus = ROOT / "examples" / "conformance"
    reset_counts()
    t0 = time.perf_counter()
    fails = conformance.replay_corpus(corpus, device=DEV, verbose=True)
    corpus_s = time.perf_counter() - t0
    new, gone = cases.unexpected_failures(fails)
    if new or gone:
        fail(f"conformance corpus on the card: failures not on record "
             f"{[str(f) for f in new]}, records that did not recur {gone}")
    fuzz_fails, seed_s = [], {}
    for seed in FUZZ_SEEDS:
        t0 = time.perf_counter()
        fuzz_fails += conformance.fuzz(
            1, seed, shrink=False, device=DEV, verbose=True,
            failures_dir=OUT_DIR / "conformance_failures")
        seed_s[seed] = time.perf_counter() - t0
    fuzz_s = sum(seed_s.values())
    if fuzz_fails:
        fail(f"conformance fuzz on the card: {[str(f) for f in fuzz_fails]}")
    launches = counts()
    if launches["fused_steps"] <= 0:
        fail("the conformance phase launched no fused_steps")
    emit("conformance", corpus=sorted(p.name for p in corpus.glob("*.json")),
         checks=list(conformance.CHECK_NAMES), corpus_s=corpus_s,
         corpus_failures=[str(f) for f in fails],
         corpus_failures_on_record="ROADMAP C14", fuzz_seeds=[
             FUZZ_SEEDS.start, FUZZ_SEEDS.stop], fuzz_s=fuzz_s,
         fuzz_seed_s=seed_s,
         fuzz_failures=0, launches=launches)


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


# -- the model zoo -----------------------------------------------------------------


def family_batch(cfg, B, S, gen, device):
    """Tokens (B, S) and, for vlm / encdec, patches / frames (x 0.02) drawn
    from ``gen`` on ``device``."""
    b = {"tokens": torch.randint(0, cfg.vocab, (B, S), generator=gen,
                                 device=device)}
    if cfg.family == "vlm":
        b["patches"] = 0.02 * torch.randn(B, cfg.n_patches, cfg.vision_dim,
                                          generator=gen, device=device)
    if cfg.family == "encdec":
        b["frames"] = 0.02 * torch.randn(B, cfg.n_frames, cfg.d_model,
                                         generator=gen, device=device)
    return b


def teacher_forced(api, cfg, params, b, steps, max_len, device):
    """Logits (B, steps, V) of ``steps`` decode steps fed ``b``'s tokens."""
    B = b["tokens"].shape[0]
    cache = api.init_cache(cfg, B, max_len, device=device)
    if cfg.family == "encdec":
        enc = wh.encode(params, b["frames"], cfg)
        cache["xk"], cache["xv"] = wh.precompute_cross_kv(params, enc, cfg)
    outs = []
    for i in range(steps):
        lg, cache = api.decode(params, cache, b["tokens"][:, i:i + 1], cfg)
        outs.append(lg[:, 0])
    return torch.stack(outs, dim=1)


def rel_diff(got, want):
    """max |got - want| over max |want| (+1e-9), the reference's parity
    measure."""
    g, w = got.float(), want.float()
    return float((g - w).abs().max()) / (float(w.abs().max()) + 1e-9)


def family_smoke(arch, seed):
    """One arch at its smoke config: the card against the port's CPU run on
    the same parameters (drawn on the host from ``seed``), and the parity
    protocol on the card."""
    cfg = smoke_config(ARCHS[arch])
    api = zoo.get_api(cfg)
    gen = torch.Generator().manual_seed(seed)
    p_cpu = layers.init_params(api.param_specs(cfg), gen)
    b_cpu = family_batch(cfg, 2, 32, gen, "cpu")
    want, _ = api.logits(p_cpu, b_cpu, cfg)
    p_dev = layers.map_tree(lambda t: t.to(DEV), p_cpu)
    b_dev = {k: v.to(DEV) for k, v in b_cpu.items()}
    got, aux = api.logits(p_dev, b_dev, cfg)
    rec = {"arch": arch, "max_abs_err_vs_cpu": float(
        (got.float().cpu() - want.float()).abs().max()),
        "tol": cases.MODEL_TOL,
        "finite": bool(torch.isfinite(got.float()).all()
                       and torch.isfinite(aux))}
    if arch in SMOKE_PARITY_ARCHS:
        pcfg = cfg.replace(capacity_factor=64.0) if cfg.family == "moe" \
            else cfg
        b10 = {k: (v[:, :10] if k == "tokens" else v)
               for k, v in b_dev.items()}
        full, _ = api.logits(p_dev, b10, pcfg)
        step = teacher_forced(api, pcfg, p_dev, b10, 10, 12, DEV)
        rec.update(parity_rel=rel_diff(step, full),
                   parity_tol=cases.PARITY_TOL[arch])
    return rec


def family_full(arch, seed):
    """One arch at full width: init on the card, forward (warm, then timed),
    64 teacher-forced decode steps, parity; rwkv6-3b also times the wkv6
    kernel at its own recurrence's inputs.  Frees everything it made."""
    cfg = ARCHS[arch]
    if cfg.family == "moe":
        cfg = cfg.replace(capacity_factor=64.0)
    api = zoo.get_api(cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=DEV).manual_seed(seed)
    t0 = time.perf_counter()
    params = layers.init_params(api.param_specs(cfg), gen)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    param_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    b = family_batch(cfg, FAMILY_B, FAMILY_S, gen, DEV)
    api.logits(params, b, cfg)                       # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    full, aux = api.logits(params, b, cfg)
    torch.cuda.synchronize()
    forward_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    step = teacher_forced(api, cfg, params, b, FAMILY_S, FAMILY_S, DEV)
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) * 1e3 / FAMILY_S
    rec = {"arch": arch, "family": cfg.family, "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "param_bytes": param_bytes,
           "peak_allocated_bytes": torch.cuda.max_memory_allocated(),
           "init_peak_allocated_bytes": init_peak, "init_s": init_s,
           "forward_s": forward_s, "forward_shape": list(full.shape),
           "decode_ms_per_step": decode_ms, "decode_steps": FAMILY_S,
           "finite": bool(torch.isfinite(full.float()).all()
                          and torch.isfinite(aux)
                          and torch.isfinite(step.float()).all())}
    if arch not in NO_PARITY:
        rec.update(parity_rel=rel_diff(step, full),
                   parity_tol=cases.PARITY_TOL[arch])
    if arch == "rwkv6-3b":
        n0 = wk.wkv6.launches
        rec["wkv_model_shape"] = wkv_model_shape(params, cfg, b["tokens"],
                                                 gen)
        rec["wkv_measure_launches"] = wk.wkv6.launches - n0
    del params, full, step, b
    torch.cuda.empty_cache()
    return rec


def _wkv_layer0_inputs(params, cfg, tokens):
    """r, k, v, log_w, u of rwkv6's layer 0 for ``tokens`` (float32)."""
    lw = layers.take_layer(params["layers"], 0)
    x = layers.layer_norm(layers.embed(params, tokens), params["ln_in"],
                          params["ln_in_b"])
    h = layers.layer_norm(x, lw["ln1"], lw["ln1_b"])
    r, k, v, _, lwh, u = rwkv6._wkv_inputs(h, rwkv6._shift(h), lw, cfg)
    return r, k, v, lwh, u


def wkv_model_shape(params, cfg, tokens, gen):
    """The wkv6 kernel at rwkv6-3b's own recurrence inputs (H 40, D 64,
    chunk ``cfg.ssm_chunk`` 32), beside the model's ``wkv_chunked``: the
    forward's layer 0 and a B 8 x S 4096 batch's.  float32 r/k/v
    (``scalar_f32``) and their bf16 casts (``chunk_tc_bf16``), each held to
    ``wkv_chunked`` on the same values; CUDA events after a warm-up, in turns
    (plain, f32, bf16, bf16, f32, plain).  Measurement only: the model runs
    ``wkv_chunked``, as the reference does."""
    C = cfg.ssm_chunk
    big = torch.randint(0, cfg.vocab, WKV_MODEL_BIG, generator=gen,
                        device=DEV)
    out = {}
    for name, tok in (("forward", tokens), ("B8xS4096", big)):
        r, k, v, lwh, u = _wkv_layer0_inputs(params, cfg, tok)
        rb, kb, vb = (t.to(torch.bfloat16) for t in (r, k, v))
        fns = {
            "plain": lambda: rwkv6.wkv_chunked(r, k, v, lwh, u, C)[0],
            "scalar_f32": lambda: ops.wkv6(r, k, v, lwh, u, chunk=C),
            "chunk_tc_bf16": lambda: ops.wkv6(rb, kb, vb, lwh, u, chunk=C)}
        before = dict(wk.wkv6.launches_by_instance)
        want = fns["plain"]()
        want_bf = rwkv6.wkv_chunked(rb.float(), kb.float(), vb.float(), lwh,
                                    u, C)[0]
        got = {i: fns[i]() for i in ("scalar_f32", "chunk_tc_bf16")}
        torch.cuda.synchronize()
        ran = {i: n - before[i] for i, n in
               wk.wkv6.launches_by_instance.items()}
        if ran != {"scalar_f32": 1, "chunk_tc_bf16": 1}:
            fail(f"wkv6 at the model's {name} shape ran {ran}")
        checks = {}
        for inst, ref in (("scalar_f32", want), ("chunk_tc_bf16", want_bf)):
            dt = "float32" if inst == "scalar_f32" else "bfloat16"
            checks[inst] = {
                "scaled_max_abs_err": cases.wkv_err(got[inst], ref),
                "tol": cases.tol(dt),
                "max_row_rel_err": cases.row_rel_err(got[inst], ref),
                "row_tol": cases.WKV_ROW_TOL,
                "finite": bool(torch.isfinite(got[inst]).all())}
        reps = 50 if name == "forward" else 5
        turns = {i: [] for i in fns}
        for i in ("plain", "scalar_f32", "chunk_tc_bf16", "chunk_tc_bf16",
                  "scalar_f32", "plain"):
            turns[i].append(cuda_ms(fns[i], reps))
        B, S, H, D = r.shape
        flops = kbench.wkv6_counts(B, S, H, D)[0]
        n = B * S * H * D
        bounds = {
            "scalar_f32": kbench.card_bound(flops, n * 5 * 4 + 4 * H * D,
                                            kbench.PEAK_FLOPS_F32),
            "chunk_tc_bf16": kbench.card_bound(
                flops, kbench.wkv6_card_bytes(B, S, H, D),
                kbench.PEAK_FLOPS_F32)}
        out[name] = {
            "shape": [B, S, H, D], "chunk": C, "reps": reps,
            "ms_turns": turns,
            "ms": {i: float(np.mean(t)) for i, t in turns.items()},
            "bound_ms": {i: b[0] for i, b in bounds.items()},
            "bound_by": {i: b[1] for i, b in bounds.items()},
            "checks": checks, "launches_by_instance": ran}
        del r, k, v, lwh, u, rb, kb, vb, want, want_bf, got
        torch.cuda.empty_cache()
    return out


def phase_model_families(seed):
    """The model zoo on the card: every arch at its smoke config against the
    port's CPU run, then the six archs of the families beside the dense
    transformer at full width.  The counts are set to 0 just before the
    full-width runs and read just after: the models call no hand-written
    kernel, as in the reference (the wkv6 timing inside is a measurement,
    and its launches are its own).  Decode-vs-forward misses are held to
    ``FAMILY_PARITY_KNOWN_MISSES`` exactly.  Fails after printing if any
    check failed."""
    t0 = time.perf_counter()
    smoke = [family_smoke(a, seed) for a in sorted(ARCHS)]
    smoke_s = time.perf_counter() - t0
    reset_counts()
    t0 = time.perf_counter()
    full = [family_full(a, seed) for a in FAMILY_ARCHS]
    full_s = time.perf_counter() - t0
    launches = counts()
    wkv_launches = sum(f.get("wkv_measure_launches", 0) for f in full)
    bad = []
    known = cases.FAMILY_PARITY_KNOWN_MISSES.get(seed, {})
    for scope, recs in (("smoke", smoke), ("full", full)):
        for rec in recs:
            if not rec["finite"]:
                bad.append(f"{rec['arch']} {scope}: non-finite logits")
            if "parity_rel" not in rec:
                continue
            miss = known.get((scope, rec["arch"]))
            rec["parity_known_miss"] = miss
            if miss is not None and rec["parity_rel"] != miss:
                bad.append(f"{rec['arch']} {scope}: the recorded parity miss "
                           f"{miss!r} did not recur: {rec['parity_rel']!r}")
            if miss is None and not rec["parity_rel"] < rec["parity_tol"]:
                bad.append(f"{rec['arch']} {scope} parity "
                           f"{rec['parity_rel']!r} >= {rec['parity_tol']}")
    for rec in smoke:
        if not rec["max_abs_err_vs_cpu"] <= rec["tol"]:
            bad.append(f"{rec['arch']} smoke: card vs CPU {rec}")
    for rec in full:
        for name, m in rec.get("wkv_model_shape", {}).items():
            for inst, c in m["checks"].items():
                if not (c["finite"] and c["scaled_max_abs_err"] <= c["tol"]
                        and c["max_row_rel_err"] <= c["row_tol"]):
                    bad.append(f"wkv6 {inst} at the model's {name} shape "
                               f"disagrees with wkv_chunked: {c}")
    others = {k: n for k, n in launches.items() if k != "wkv6"}
    if any(others.values()) or launches["wkv6"] != wkv_launches:
        bad.append(f"the model path launched a hand-written kernel: "
                   f"{launches} (wkv6 measurement {wkv_launches})")
    emit("model_families", smoke_s=smoke_s, full_s=full_s, smoke=smoke,
         full=full, launches=launches, wkv_measure_launches=wkv_launches)
    emit("model_families_summary", archs={
        r["arch"]: {k: r[k] for k in ("param_bytes", "peak_allocated_bytes",
                                      "forward_s", "decode_ms_per_step")}
        for r in full})
    if bad:
        fail("model_families: " + "; ".join(bad))
    return full


# -- training ------------------------------------------------------------------


def _flash_grads(fn, qkv, cot):
    leaves = [t.clone().requires_grad_() for t in qkv]
    out = fn(*leaves)
    return torch.autograd.grad((out.float() * cot).sum(), leaves)


def _grad_errs(got, want, causal):
    """Per gradient: the largest ``|got - want|`` over the largest
    ``|want|``, and the largest row error relative to the row (dq's rows at
    position 0 left out under a causal mask: that query sees one key, and
    its dq is 0 in exact arithmetic)."""
    out = {}
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        g, w = g.float(), w.float()
        scaled = float((g - w).abs().max()) / float(w.abs().max())
        if name == "dq" and causal:
            g, w = g[:, 1:], w[:, 1:]
        out[name] = {"scaled_max_abs_err": scaled,
                     "max_row_rel_err": cases.row_rel_err(g, w)}
    return out


def flash_bwd_check(seed):
    """The blockwise attention's backward at qwen2.5-3b's layer shape
    against plain autograd of the same forward loop on the card, as
    ``tests/test_torch_flash_bwd.py`` holds it on the CPU.  float32: the
    whole path within the ``FLASH_*`` float32 bounds (5e-5 of the largest
    value, and each row within ``FLASH_ROW_TOL``).  bfloat16: the backward
    fed the forward's float32 output as its residual, every row of dq, dk,
    dv within ``FLASH_ROW_TOL`` and 3e-2 of the largest value; and the
    whole path (the reference's bfloat16 ``out`` residual, ``ROADMAP.md``
    C25): dk and dv rows within ``FLASH_ROW_TOL``, dq within 3e-2 of its
    largest value, its worst row recorded.  Also the forward + backward
    time of each beside plain autograd's."""
    B, S, Hq, Hkv, D = FLASH_BWD_SHAPE
    gen = torch.Generator(device=DEV).manual_seed(seed)
    f32 = [torch.randn(s, generator=gen, device=DEV)
           for s in ((B, S, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D))]
    cot = torch.randn((B, S, Hq, D), generator=gen, device=DEV)
    bkv = 1024
    checks, bad = {}, []
    for dtype in (torch.float32, torch.bfloat16):
        qkv = [t.to(dtype) for t in f32]
        name = str(dtype).split(".")[1]

        def custom():
            return _flash_grads(lambda q, k, v: layers.attention(
                q, k, v, causal=True, block_kv=bkv), qkv, cot)

        def plain():
            return _flash_grads(lambda q, k, v: layers._flash_fwd(
                q, k, v, True, 0, bkv)[0], qkv, cot)

        got, want = custom(), plain()
        rec = {"whole_path": _grad_errs(got, want, True)}
        if dtype == torch.bfloat16:
            out32, lse = layers._flash_fwd(*(t.float() for t in qkv), True,
                                           0, bkv)
            alone = layers._flash_bwd(*qkv, out32, lse, cot.to(dtype), True,
                                      0, bkv)
            rec["backward_f32_residual"] = _grad_errs(alone, want, True)
            held = rec["backward_f32_residual"]
            whole = rec["whole_path"]
            tol = cases.tol("bfloat16")
            for g, e in held.items():
                if not (e["scaled_max_abs_err"] <= tol
                        and e["max_row_rel_err"] <= FLASH_ROW_TOL):
                    bad.append(f"bf16 {g} (float32 residual): {e}")
            for g, e in whole.items():
                if not e["scaled_max_abs_err"] <= tol or (
                        g != "dq" and e["max_row_rel_err"] > FLASH_ROW_TOL):
                    bad.append(f"bf16 {g} (whole path): {e}")
            del alone, out32, lse
        else:
            tol = cases.tol("float32")
            for g, e in rec["whole_path"].items():
                if not (e["scaled_max_abs_err"] <= tol
                        and e["max_row_rel_err"] <= FLASH_ROW_TOL):
                    bad.append(f"float32 {g}: {e}")
        rec["finite"] = all(bool(torch.isfinite(t).all()) for t in got)
        if not rec["finite"]:
            bad.append(f"{name}: non-finite gradients")
        del got, want
        torch.cuda.empty_cache()
        rec["custom_ms"] = cuda_ms(custom, 3)
        torch.cuda.reset_peak_memory_stats()
        custom()
        rec["custom_peak_bytes"] = torch.cuda.max_memory_allocated()
        rec["plain_ms"] = cuda_ms(plain, 3)
        torch.cuda.reset_peak_memory_stats()
        plain()
        rec["plain_peak_bytes"] = torch.cuda.max_memory_allocated()
        checks[name] = rec
        torch.cuda.empty_cache()
    return checks, bad


def _sample(t, n=1 << 16):
    return t.detach().reshape(-1)[:n].clone()


def _kernel_class(name):
    n = name.lower()
    if any(w in n for w in ("gemm", "cutlass", "xmma", "nvjet", "cublas")):
        return "gemm"
    if "reduce" in n:
        return "reduce"
    if "elementwise" in n or "vectorized" in n or "unrolled" in n:
        return "elementwise"
    if "memcpy" in n or "memset" in n or "copy" in n:
        return "copy"
    return "other"


def profile_train_step(step, state, batch):
    """One more step (a 7th, outside the 6 measured) under
    ``torch.profiler``: the device's kernel time by class (GEMMs,
    elementwise, reductions, copies, other) and the 12 costliest kernels,
    beside the step's wall time; the device idle share is 1 - kernel time /
    wall time."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_class, kernels = {}, []
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0))
        if not us or ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        c = _kernel_class(ev.key)
        by_class[c] = by_class.get(c, 0.0) + us / 1e6
        kernels.append((us / 1e6, ev.count, ev.key[:120]))
    busy = sum(by_class.values())
    kernels.sort(reverse=True)
    return {"wall_s": wall, "device_kernel_s": busy,
            "device_idle_share": 1.0 - busy / wall if busy else None,
            "kernel_s_by_class": by_class,
            "top_kernels": [{"s": s_, "count": n, "name": k}
                            for s_, n, k in kernels[:12]],
            "note": "profiled, so slower than the measured steps"}


def phase_train_path(seed):
    """qwen2.5-3b trained at full width and depth on the card: 6 AdamW steps
    through ``make_train_step`` (per-layer remat, the state donated leaf by
    leaf) on ``synthetic_batches`` prefetched to the card, in a counted
    window; then the blockwise backward's check at its layer shape.  Fails
    unless every loss and grad norm is finite, the first loss is below
    2 ln V (``tests/test_models.py``'s bound), every weight matrix has
    moved after step 2, no hand-written kernel ran (as in the reference)
    and the backward check holds."""
    cfg = ARCHS[TRAIN_ARCH]
    api = zoo.get_api(cfg)
    specs = api.param_specs(cfg)
    n_params, n_active = count_params(specs), active_params(cfg, specs)
    hp = TrainHParams(**TRAIN_HP)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=DEV).manual_seed(seed)
    t0 = time.perf_counter()
    state = init_train_state(layers.init_params(specs, gen), hp)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    before = {"/".join(p): _sample(t)
              for p, t in leaf_paths(state["params"])}
    marks = []

    def mark(grads):
        """The step's hook between the gradients and AdamW: the time the
        forward and backward took (synchronised), for the optimiser's
        share."""
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        return grads

    step = make_train_step(api, cfg, hp, grad_transform=mark)
    data = prefetch(synthetic_batches(DataConfig(
        global_batch=TRAIN_B, seq_len=TRAIN_S, vocab=cfg.vocab, seed=seed)),
        device=DEV)
    reset_counts()
    step_s, grad_s, losses, gnorms, lrs, moved = [], [], [], [], [], {}
    for i in range(TRAIN_STEPS):
        batch = next(data)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        grad_s.append(marks[-1] - t0)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
        lrs.append(float(m["lr"]))
        if i == 1:
            for p, t in leaf_paths(state["params"]):
                key = "/".join(p)
                moved[key] = float((_sample(t) != before[key]).float()
                                   .mean())
    launches = counts()
    peak = torch.cuda.max_memory_allocated()
    final = leaf_samples(state)      # dist_path holds its run to these bits
    profile = profile_train_step(step, state, next(data))
    del state, data, batch, m, before
    torch.cuda.empty_cache()
    warm = sorted(step_s[1:])
    med = warm[len(warm) // 2]
    tokens = TRAIN_B * TRAIN_S
    flops = model_flops(cfg, Shape("train_path", TRAIN_S, TRAIN_B, "train"),
                        n_params, n_active)
    t0 = time.perf_counter()
    bwd, bad = flash_bwd_check(seed)
    bwd_s = time.perf_counter() - t0
    if not all(math.isfinite(x) for x in losses + gnorms):
        bad.append(f"non-finite loss or grad norm: {losses} {gnorms}")
    if not losses[0] < 2.0 * math.log(cfg.vocab):
        bad.append(f"first loss {losses[0]} >= 2 ln V")
    still = [k for k, f in moved.items()
             if k.split("/")[-1] not in ("attn_norm", "mlp_norm",
                                         "final_norm") and f == 0.0]
    if still:
        bad.append(f"weights unmoved after step 2: {still}")
    if any(launches.values()):
        bad.append(f"the training path launched a hand-written kernel: "
                   f"{launches}")
    rec = dict(
        arch=TRAIN_ARCH, n_layers=cfg.n_layers, d_model=cfg.d_model,
        vocab=cfg.vocab, n_params=n_params, batch=TRAIN_B, seq=TRAIN_S,
        steps=TRAIN_STEPS, hparams=TRAIN_HP, remat=hp.remat,
        init_s=init_s, init_peak_allocated_bytes=init_peak,
        step_s=step_s, first_step_s=step_s[0], median_step_s_2_to_6=med,
        forward_backward_s=grad_s,
        optimizer_s=[a - b for a, b in zip(step_s, grad_s)],
        profiled_step=profile,
        tokens_per_step=tokens, tokens_per_s=tokens / med,
        model_flops_per_step=flops,
        mfu=flops / (med * PEAK_FLOP_PER_S["bfloat16"]),
        mfu_peak="989e12 bf16 dense FLOP/s", peak_allocated_bytes=peak,
        loss=losses, grad_norm=gnorms, lr=lrs,
        loss_bound_2lnV=2.0 * math.log(cfg.vocab),
        frac_moved_after_step_2=moved, launches=launches,
        flash_bwd=dict(shape=dict(zip(("B", "S", "Hq", "Hkv", "D"),
                                      FLASH_BWD_SHAPE)), block_kv=1024,
                       causal=True, seconds=bwd_s, **bwd))
    emit("train_path", **rec)
    if bad:
        fail("train_path: " + "; ".join(bad))
    return dict(rec, final_samples=final)


def leaf_samples(state, n=1 << 16):
    """About ``n`` entries spread over every leaf of a train state (params,
    both moments, count), each leaf gathered whole first (a DTensor's
    collective), as host tensors keyed by path."""
    from repro_torch.distributed.sharding import full

    out = {}
    for p, t in leaf_paths(state):
        flat = full(t).detach().reshape(-1)
        out["/".join(p)] = flat[::max(1, flat.numel() // n)][:n].cpu()
    return out


def _bits_equal(a, b):
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        view = {2: torch.int16, 4: torch.int32, 8: torch.int64}[
            a.element_size()]
        return torch.equal(a.view(view), b.view(view))
    return torch.equal(a, b)


LAUNCH_LINE = re.compile(
    r"^step\s+(\d+) loss=(\S+) gnorm=(\S+) wall=(\S+)s$")


def phase_dist_path(seed, train, sc, art):
    """The distribution layer on the card (one card: a 1x1 NCCL mesh):

    1. qwen2.5-3b at full width and depth through ``Trainer(mesh=
       make_local_mesh())``'s step -- DTensors on the mesh, the step under
       ``mesh_context`` -- at ``train_path``'s B x S, seed, hyper-parameters
       and batches; every step's loss and grad norm, and samples spread over
       every leaf after the last step, bit-equal to ``train_path``'s; step s,
       peak memory and a 7th step under ``torch.profiler`` (the device's
       idle share) beside ``train_path``'s: DTensor's dispatch cost on a
       world of one;
    2. that run's parameters checkpointed and restored by
       ``elastic_restore`` onto a fresh 1x1 mesh, bit-equal;
    3. ``make_crosspod_psum``: ``None`` on the 1x1 ``(data, model)`` mesh;
       on a (1, 1, 1) ``(pod, data, model)`` mesh ``dequantize(q, s)`` bit
       for bit;
    4. the main path's grid with ``host_devices=1`` bit-equal to the default
       run, with the same launches; ``host_devices`` past the visible cards
       raises, and with two cards the split runs, bit-equal;
    5. ``python -m repro_torch.launch.train --arch qwen2.5-3b --steps 20``
       (smoke config, on the card) in a process of its own."""
    import tempfile

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.distributed.sharding import full
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.optim.grad_compress import (dequantize,
                                                 ef_compress_grads,
                                                 make_crosspod_psum)
    from repro_torch.train.ft import elastic_restore
    from repro_torch.train.trainer import Trainer

    t_phase = time.perf_counter()
    bad = []
    cfg = ARCHS[TRAIN_ARCH]
    hp = TrainHParams(**TRAIN_HP)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    work = Path(tempfile.mkdtemp(prefix="dist_path_"))
    mesh = make_local_mesh()
    tr = Trainer(cfg, hp, mesh=mesh, ckpt_dir=str(work / "fit"),
                 ckpt_every=0, seed=seed)
    tr.hp_global_batch, tr.hp_seq_len = TRAIN_B, TRAIN_S
    t0 = time.perf_counter()
    state = tr.init_state()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    data = tr.data_iter(0)
    reset_counts()
    step_s, losses, gnorms = [], [], []
    for _ in range(TRAIN_STEPS):
        batch = next(data)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = tr.train_step(state, batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
    launches = counts()
    peak = torch.cuda.max_memory_allocated()
    placements = sorted({str(t.placements) for _, t in leaf_paths(state)})
    final = leaf_samples(state)
    if any(launches.values()):
        bad.append(f"the sharded training path launched a hand-written "
                   f"kernel: {launches}")
    if losses != train["loss"] or gnorms != train["grad_norm"]:
        bad.append(f"1x1 mesh steps differ from train_path: loss {losses} "
                   f"vs {train['loss']}, grad norm {gnorms} vs "
                   f"{train['grad_norm']}")
    want = train["final_samples"]
    differ = sorted(k for k in want
                    if k not in final or not _bits_equal(final[k], want[k]))
    if differ or sorted(final) != sorted(want):
        bad.append(f"leaves not bit-equal to train_path after step "
                   f"{TRAIN_STEPS}: {differ[:8]}")
    profile = profile_train_step(tr.train_step, state, next(data))
    del batch, m, data, final
    for k in ("m", "v"):
        state["opt"][k] = None
    torch.cuda.empty_cache()
    warm = sorted(step_s[1:])
    med = warm[len(warm) // 2]

    # 2. elastic restore onto a fresh 1x1 mesh
    t0 = time.perf_counter()
    ckpt.save(str(work / "elastic"), TRAIN_STEPS, state["params"])
    save_s = time.perf_counter() - t0
    fresh = make_local_mesh()
    t0 = time.perf_counter()
    back = elastic_restore(str(work / "elastic"), TRAIN_STEPS,
                           layers.abstract_params(tr.specs), fresh, tr.specs)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    restored_differ = [
        "/".join(p) for p, t in leaf_paths(state["params"])
        if not _bits_equal(full(t), full(get_leaf(back, p)))]
    if restored_differ:
        bad.append(f"elastic_restore not bit-equal: {restored_differ[:8]}")
    n_leaves = len(leaf_paths(back))
    del state, back
    shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()

    # 3. the cross-pod reduction
    none_without_pod = make_crosspod_psum(mesh) is None
    if not none_without_pod:
        bad.append("make_crosspod_psum on a mesh without a pod axis is not "
                   "None")
    pods = init_device_mesh("cuda", (1, 1, 1),
                            mesh_dim_names=("pod", "data", "model"))
    g = torch.randn(1 << 20, device=DEV,
                    generator=torch.Generator(DEV).manual_seed(seed))
    q, s, _ = ef_compress_grads({"g": g}, {"g": torch.zeros_like(g)})
    got = make_crosspod_psum(pods)(q, s)["g"]
    crosspod_equal = _bits_equal(got, dequantize(q["g"], s["g"]))
    if not crosspod_equal:
        bad.append("make_crosspod_psum on (1, 1, 1) differs from "
                   "dequantize(q, s)")

    # 4. the grid's cell axis
    tr_ = art.trace_result.trace
    cfg_ = sc.sim_config()
    grid_args = (cfg_, tr_, sc.latencies_sec(), sc.thread_candidates)
    grids, grid_launches = {}, {}
    n_cards = torch.cuda.device_count()
    for n in (None, 1) + ((2,) if n_cards >= 2 else ()):
        reset_counts()
        grids[n] = rt.sweep_grid(*grid_args, n_ops=sc.n_ops, host_devices=n)
        torch.cuda.synchronize()
        grid_launches[n] = counts()["fused_steps"]
    planes = ("throughput", "time", "mem_stall_total", "mem_accesses")
    for n in grids:
        if any(not np.array_equal(getattr(grids[n], f),
                                  getattr(grids[None], f)) for f in planes):
            bad.append(f"host_devices={n} grid differs from the default")
    if grid_launches[1] != grid_launches[None]:
        bad.append(f"host_devices=1 launched {grid_launches[1]} times, the "
                   f"default {grid_launches[None]}")
    refused = None
    try:
        rt.sweep_grid(*grid_args, n_ops=sc.n_ops, host_devices=n_cards + 1)
        bad.append(f"host_devices={n_cards + 1} on {n_cards} card(s) did "
                   "not raise")
    except ValueError as e:
        refused = str(e)
    dist.destroy_process_group()

    # 5. the training launcher
    with tempfile.TemporaryDirectory(prefix="launch_train_") as ck:
        out, _, launch_s = run_module(
            "repro_torch.launch.train", "--arch", TRAIN_ARCH, "--steps", 20,
            "--ckpt", ck, timeout=300)
    rows = [LAUNCH_LINE.match(line) for line in out.strip().splitlines()]
    if not rows or not all(rows):
        bad.append(f"launch.train printed lines that do not parse: "
                   f"{out[-1500:]}")
    launch_losses = [float(r.group(2)) for r in rows if r]
    if not all(math.isfinite(x) for x in launch_losses):
        bad.append(f"launch.train loss not finite: {launch_losses}")
    rec = dict(
        mesh={"shape": [1, 1], "dims": ["data", "model"], "backend": "nccl",
              "world": 1},
        arch=TRAIN_ARCH, batch=TRAIN_B, seq=TRAIN_S, steps=TRAIN_STEPS,
        init_s=init_s, step_s=step_s, median_step_s_2_to_6=med,
        train_path_median_step_s_2_to_6=train["median_step_s_2_to_6"],
        step_s_over_train_path=med / train["median_step_s_2_to_6"],
        peak_allocated_bytes=peak,
        train_path_peak_allocated_bytes=train["peak_allocated_bytes"],
        profiled_step=profile,
        train_path_profiled_step={k: train["profiled_step"][k] for k in (
            "wall_s", "device_kernel_s", "device_idle_share")},
        loss=losses, grad_norm=gnorms, bit_equal_to_train_path=not any(
            "train_path" in b for b in bad),
        leaves_sampled=len(want), placements=placements,
        launches=launches,
        elastic={"leaves": n_leaves, "save_s": save_s,
                 "restore_s": restore_s,
                 "bit_equal": not restored_differ},
        crosspod={"none_without_pod": none_without_pod,
                  "bit_equal_dequantize": crosspod_equal,
                  "numel": int(g.numel())},
        grid={"cells": int(grids[None].throughput.size),
              "launches": {str(k): v for k, v in grid_launches.items()},
              "refused": refused, "cards": n_cards},
        launch_train={"lines": len(rows), "loss": launch_losses,
                      "wall_s": launch_s},
        seconds=time.perf_counter() - t_phase)
    emit("dist_path", **rec)
    if bad:
        fail("dist_path: " + "; ".join(bad))
    return rec


def _dryrun_train_cell(mesh):
    """The dry run's cell at ``train_path``'s shape: qwen2.5-3b at full
    width and depth, B 2 x S 2048, one microbatch, per-layer remat."""
    from repro_torch.launch.specs import make_cell

    return make_cell(TRAIN_ARCH, "train_path", mesh,
                     hp=TrainHParams(**TRAIN_HP),
                     shape=Shape("train_path", TRAIN_S, TRAIN_B, "train"))


def dryrun_one(out_path):
    """``--dryrun-1x1 OUT``: the 1x1 cell counted as the dry run counts a
    cell (``FakeTensorMode``, a fake process group of one rank, the card's
    device type), its metrics written to ``OUT`` as JSON.  Run in a process
    of its own: the fake group is the process's."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_local_mesh

    dryrun.fake_world(1)
    mesh = make_local_mesh()
    t0 = time.perf_counter()
    m = dryrun.count_cell(_dryrun_train_cell(mesh), "cuda")
    m["host_s"] = time.perf_counter() - t0
    Path(out_path).write_text(json.dumps(m))


def phase_dryrun_path(seed):
    """The dry run (``repro_torch.launch.dryrun``) on the card's machine:

    1. qwen2.5-3b's ``train_4k``, ``prefill_32k`` and ``decode_32k`` on the
       (16, 16) mesh and ``train_4k`` on (2, 16, 16), each counted under
       ``FakeTensorMode`` on a fake process group of the mesh's world (256
       or 512 ranks), one process a mesh; every row ``ok``, printed with
       its host seconds;
    2. the cell at ``train_path``'s shape (1x1 mesh, B 2 x S 2048, one
       microbatch, remat) counted the same way in a process of its own,
       beside one real step of that cell on the card's 1x1 NCCL mesh from
       the state ``dist_path`` draws, counted by the same
       :class:`~repro_torch.roofline.analysis.OpCounter`: the FLOPs equal
       to the count, the predicted per-device memory within
       ``DRYRUN_MEM_BAND`` of the step's measured peak
       (``max_memory_allocated`` past what was allocated before its state),
       no hand-written kernel launched, and ``t_compute`` beside a second,
       uncounted step's seconds."""
    import gc
    import tempfile

    import torch.distributed as dist

    from repro_torch.distributed.sharding import (batch_shardings, full,
                                                  place_)
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.roofline.analysis import OpCounter, RooflineTerms
    from repro_torch.train.trainer import Trainer

    t_phase = time.perf_counter()
    bad = []
    out = OUT_DIR / "dryrun"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src")] + [p for p in [os.environ.get("PYTHONPATH")]
                               if p]))
    one_path = out / "train_path_1x1.json"
    cmds = {mesh_name: ["-m", "repro_torch.launch.dryrun", "--arch",
                        TRAIN_ARCH, "--shape", shapes, "--mesh", mesh_name,
                        "--out", str(out)]
            for mesh_name, shapes in DRYRUN_CELLS}
    cmds["1x1"] = [str(ROOT / "chip_smoke.py"), "--dryrun-1x1",
                   str(one_path)]
    procs = {k: (time.perf_counter(), subprocess.Popen(
        [sys.executable, *v], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, cwd=ROOT, env=env)) for k, v in cmds.items()}

    # the real step of the 1x1 cell, counted, while the counts run
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    mesh = make_local_mesh()
    cell = _dryrun_train_cell(mesh)
    with tempfile.TemporaryDirectory(prefix="dryrun_path_") as ck:
        tr = Trainer(ARCHS[TRAIN_ARCH], TrainHParams(**TRAIN_HP), mesh=mesh,
                     ckpt_dir=ck, ckpt_every=0, seed=seed)
        tr.hp_global_batch, tr.hp_seq_len = TRAIN_B, TRAIN_S
        state = tr.init_state()
        data = tr.data_iter(0)
        batches = [next(data) for _ in range(2)]
    batches = [place_(dict(b), batch_shardings(b, mesh)) for b in batches]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    counter = OpCounter()
    with counter:
        state, metrics = cell.fn(state, batches[0])
    torch.cuda.synchronize()
    launches = counts()
    measured = torch.cuda.max_memory_allocated() - base
    loss = float(full(metrics["loss"]))
    if any(launches.values()):
        bad.append(f"the dry run's training cell launched a hand-written "
                   f"kernel: {launches}")

    runs = {}
    for k, (t0, proc) in procs.items():
        try:
            so, se = proc.communicate(timeout=600)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        runs[k] = {"wall_s": time.perf_counter() - t0,
                   "rc": proc.returncode}
        if proc.returncode != 0:
            bad.append(f"dry run {k} exited {proc.returncode}: "
                       f"{so[-1500:]} {se[-3000:]}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, metrics = cell.fn(state, batches[1])
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    del state, metrics, batches, cell
    dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    if bad:
        fail("dryrun_path: " + "; ".join(bad))

    rows = []
    for mesh_name, shapes in DRYRUN_CELLS:
        for shape in shapes.split(","):
            path = out / f"{TRAIN_ARCH}__{shape}__{mesh_name}.json"
            r = json.loads(path.read_text())
            rows.append({k: r.get(k) for k in (
                "arch", "shape", "mesh", "status", "device", "chips",
                "per_device_memory", "hlo_flops", "model_flops",
                "t_compute", "t_memory", "t_collective", "bottleneck",
                "useful_ratio", "coll_counts", "microbatches", "compile_s",
                "error")})
            print(json.dumps({"dryrun_row": rows[-1]}), flush=True)
            if r.get("status") != "ok":
                bad.append(f"{shape} on {mesh_name}: {r.get('status')} "
                           f"{r.get('error', '')}")
    one = json.loads(one_path.read_text())
    predicted = one["mem"]["peak_memory_in_bytes"]
    mem_ratio = predicted / measured
    t_compute = RooflineTerms(arch=TRAIN_ARCH, shape="train_path",
                              mesh="1x1", chips=1, hlo_flops=one["flops"],
                              hlo_bytes=one["bytes"]).t_compute
    if one["flops"] != counter.flops:
        bad.append(f"1x1 cell: counted {one['flops']} FLOPs, the real step "
                   f"{counter.flops}")
    lo, hi = DRYRUN_MEM_BAND
    if not lo <= mem_ratio <= hi:
        bad.append(f"1x1 cell: predicted {predicted} B a device, the step's "
                   f"peak {measured} B (ratio {mem_ratio:.3f} outside "
                   f"[{lo}, {hi}])")
    rec = dict(
        rows=rows, processes=runs,
        one_by_one={
            "arch": TRAIN_ARCH, "batch": TRAIN_B, "seq": TRAIN_S,
            "microbatches": 1, "remat": True,
            "flops_counted": one["flops"], "flops_real_step": counter.flops,
            "bytes_counted": one["bytes"], "bytes_real_step": counter.bytes,
            "collectives_real_step": len(counter.collectives),
            "predicted_bytes": predicted, "predicted_mem": one["mem"],
            "measured_peak_bytes": measured, "memory_ratio": mem_ratio,
            "memory_band": list(DRYRUN_MEM_BAND),
            "t_compute_s": t_compute, "step_s": step_s,
            "t_compute_over_step": t_compute / step_s, "loss": loss,
            "count_host_s": one["host_s"]},
        launches=launches, seconds=time.perf_counter() - t_phase)
    emit("dryrun_path", **rec)
    if bad:
        fail("dryrun_path: " + "; ".join(bad))
    return rec


def _load_example(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def resume_check(out_dir):
    """The training example's model on the card, deterministic algorithms
    on: 6 steps straight against 3 steps, a checkpoint, a restore and 3
    more steps.  Prints one JSON line: the leaves that differ (none when
    the two runs are bit-equal).  Run in a process of its own, whose
    ``CUBLAS_WORKSPACE_CONFIG`` is set before CUDA starts."""
    torch.use_deterministic_algorithms(True)
    ex = _load_example("train_100m_torch")
    cfg = ex.CFG_100M
    api = zoo.get_api(cfg)
    n = 2 * EXAMPLE_RESUME_STEPS
    hp = ex.hparams(n)
    step = make_train_step(api, cfg, hp)
    batch, seq = int(EXAMPLE_ARGS[3]), int(EXAMPLE_ARGS[5])

    def data(start):
        return prefetch(synthetic_batches(DataConfig(
            global_batch=batch, seq_len=seq, vocab=cfg.vocab, seed=0),
            start), device=DEV)

    def fresh():
        gen = torch.Generator(device=DEV).manual_seed(0)
        return init_train_state(layers.init_params(api.param_specs(cfg),
                                                   gen), hp)

    a, it = fresh(), data(0)
    for _ in range(n):
        a, _ = step(a, next(it))
    b, it = fresh(), data(0)
    for _ in range(EXAMPLE_RESUME_STEPS):
        b, _ = step(b, next(it))
    ckpt.save(out_dir, EXAMPLE_RESUME_STEPS, b)
    like = layers.map_tree(lambda t: torch.empty_like(t, device="meta"), b)
    del b
    b = ckpt.restore(out_dir, EXAMPLE_RESUME_STEPS, like, device=DEV)
    it = data(EXAMPLE_RESUME_STEPS)
    for _ in range(EXAMPLE_RESUME_STEPS):
        b, _ = step(b, next(it))
    diff = {}
    for (p, x), (_, y) in zip(leaf_paths(a), leaf_paths(b)):
        if not torch.equal(x, y):
            diff["/".join(map(str, p))] = float(
                (x.float() - y.float()).abs().max())
    print(json.dumps({"resume_check": {
        "steps": n, "checkpoint_at": EXAMPLE_RESUME_STEPS,
        "n_leaves": len(leaf_paths(a)), "differing_leaves": diff,
        "deterministic_algorithms":
            torch.are_deterministic_algorithms_enabled(),
        "cublas_workspace_config":
            os.environ.get("CUBLAS_WORKSPACE_CONFIG")}}), flush=True)


def smoke_learns():
    """The reference's ``test_trainer_learns`` on the card: ``Trainer`` on
    qwen2.5-3b's smoke config, B 16 x S 48, 120 steps, no checkpoints."""
    import tempfile
    from repro_torch.train.trainer import Trainer
    with tempfile.TemporaryDirectory() as tmp:
        tr = Trainer(smoke_config(ARCHS[TRAIN_ARCH]),
                     TrainHParams(**LEARNS_HP), ckpt_dir=tmp, ckpt_every=0,
                     device=DEV)
        tr.hp_global_batch, tr.hp_seq_len = LEARNS_BS
        reset_counts()
        t0 = time.perf_counter()
        _, log = tr.fit(LEARNS_HP["total_steps"], resume=False)
        losses = [float(m["loss"]) for m in log]
        wall = time.perf_counter() - t0
    return {"steps": len(log), "batch": LEARNS_BS, "hparams": LEARNS_HP,
            "first10": float(np.mean(losses[:10])),
            "last10": float(np.mean(losses[-10:])), "wall_s": wall,
            "launches": counts()}


def phase_train_example():
    """Training at the examples' sizes on the card.  First the reference's
    learning test (:func:`smoke_learns`), held to its criterion (the mean
    of the last 10 losses below the mean of the first 10 by more than 1.0,
    ``tests/test_train.py``).  Then ``examples/train_100m_torch.py`` through
    its ``main`` in a counted window: 120 steps of B 8 x S 256 with
    checkpoints every 50 into a temporary directory, its last-10 mean held
    to the reference example's at the same arguments
    (``EXAMPLE_REF_LAST10``; C26); a second run must find nothing to do.
    Then the resume check (:func:`resume_check`) in a process of its own,
    which must be bit-equal.  No hand-written kernel may run."""
    import tempfile
    ex = _load_example("train_100m_torch")
    bad = []
    learns = smoke_learns()
    if not learns["last10"] < learns["first10"] - 1.0:
        bad.append(f"the reference's learning criterion failed: {learns}")
    with tempfile.TemporaryDirectory() as tmp:
        argv = [*EXAMPLE_ARGS, "--ckpt", os.path.join(tmp, "ckpt"),
                "--device", "cuda"]
        buf = io.StringIO()
        reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            log = ex.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = counts()
        losses = [float(m["loss"]) for m in log]
        first10, last10 = np.mean(losses[:10]), np.mean(losses[-10:])
        saved = sorted(os.listdir(os.path.join(tmp, "ckpt")))
        again = io.StringIO()
        with contextlib.redirect_stdout(again):
            log2 = ex.main(argv)
        rerun = again.getvalue().splitlines()
        env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
        t1 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--resume-check",
             os.path.join(tmp, "resume")], capture_output=True, text=True,
            env=env, timeout=600, cwd=str(ROOT))
        resume_s = time.perf_counter() - t1
    if len(log) != 120 or not (
            last10 < first10 and
            abs(last10 - EXAMPLE_REF_LAST10) <= EXAMPLE_LAST10_TOL):
        bad.append(f"the example's losses: first 10 {first10}, last 10 "
                   f"{last10} over {len(log)} steps (the reference's last "
                   f"10: {EXAMPLE_REF_LAST10} +- {EXAMPLE_LAST10_TOL})")
    if log2 or not rerun or not rerun[-1].startswith("nothing to do"):
        bad.append(f"the re-run did not resume to nothing to do: {rerun}")
    if any(launches.values()):
        bad.append(f"the training example launched a hand-written kernel: "
                   f"{launches}")
    resume = None
    if res.returncode != 0:
        bad.append(f"resume check exited {res.returncode}: "
                   f"{res.stderr[-3000:]}")
    else:
        resume = json.loads(res.stdout.strip().splitlines()[-1])[
            "resume_check"]
        if resume["differing_leaves"]:
            bad.append(f"resume not bit-equal: {resume['differing_leaves']}")
    emit("train_example", smoke_learns=learns, argv=list(EXAMPLE_ARGS),
         wall_s=wall, steps=len(log), loss_first10=float(first10),
         loss_last10=float(last10), ref_loss_last10=EXAMPLE_REF_LAST10,
         last10_tol=EXAMPLE_LAST10_TOL, loss=losses[::10], checkpoints=saved,
         stdout=buf.getvalue().splitlines(), rerun_stdout=rerun,
         launches=launches, resume=resume, resume_s=resume_s)
    if bad:
        fail("train_example: " + "; ".join(bad))


# -- the system's own entry points ----------------------------------------------

#: Where the loop run of the paper figures memoizes its cells, so that every
#: cell of the card's run can be held against its loop cell.
FIG_LOOP_CACHE = ROOT / "build" / "paper_figs_loop_cache"
#: The figures that sweep no grid: the same host code on either backend.
HOST_FIGS = ("fig3_model_curves", "fig10_load_latency", "fig12_extended",
             "fig14_multicore", "fig16_threads", "fig17_op_latency")
HOST_ROWS = ("fig3/", "fig10/", "fig12", "fig14/", "fig16/", "fig17/")
FIG_NAMES = tuple(f.__name__ for f in pfigs.ALL)


def run_cli(argv):
    """``benchmarks.run_torch`` in this process (so the launch counters see
    its kernels): ``(stdout, wall s)``.  A non-zero exit fails the run."""
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            run_torch.main(list(map(str, argv)))
    except SystemExit as e:
        if e.code not in (None, 0):
            fail(f"benchmarks.run_torch {' '.join(argv)} exited {e.code!r}:"
                 f"\n{buf.getvalue()[-3000:]}")
    torch.cuda.synchronize()
    return buf.getvalue(), time.perf_counter() - t0


def run_module(module, *argv, timeout=900):
    """``python -m module argv`` in a process of its own: the host loop's
    sweeps fork their workers, which a process holding a CUDA context
    cannot.  ``(stdout, stderr, wall s)``; a non-zero exit fails the run."""
    return start_module(module, *argv, timeout=timeout)()


#: processes started by :func:`start_module`, killed with their workers
#: if the run ends before they do
CHILDREN = []


def _kill_children():
    for proc in CHILDREN:
        if proc.poll() is None:
            with contextlib.suppress(OSError):
                os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()


atexit.register(_kill_children)


def start_module(module, *argv, timeout=900):
    """:func:`run_module`'s process, started now and waited for by a
    thread: the returned function waits for its end and returns
    ``(stdout, stderr, wall s)`` (the process's own wall time); a non-zero
    exit, or a run past ``timeout`` s, fails the run."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src")] + [p for p in [os.environ.get("PYTHONPATH")]
                               if p]))
    cmd = f"python -m {module} {' '.join(map(str, argv))}"
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", module, *map(str, argv)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, cwd=ROOT, env=env,
                            start_new_session=True)
    CHILDREN.append(proc)
    box = {}

    def wait():
        try:
            box["out"] = proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            box["out"], box["late"] = proc.communicate(), True
        box["wall"] = time.perf_counter() - t0

    waiter = threading.Thread(target=wait, daemon=True)
    waiter.start()

    def finish():
        waiter.join()
        out, err = box["out"]
        if box.get("late"):
            fail(f"{cmd} ran past {timeout} s:\n{err[-3000:]}")
        if proc.returncode != 0:
            fail(f"{cmd} exited {proc.returncode}:\n{out[-2000:]}\n"
                 f"{err[-3000:]}")
        return out, err, box["wall"]
    return finish


def check_doc(path):
    """``tools/check_bench.py`` on a written document; fails the run."""
    res = subprocess.run([sys.executable, str(ROOT / "tools" /
                                              "check_bench.py"), str(path)],
                         capture_output=True, text=True, timeout=120)
    if res.returncode != 0:
        fail(f"tools/check_bench.py refused {path.name}: "
             f"{res.stdout}{res.stderr}")
    return res.stdout.strip().splitlines()


def csv_rows(text):
    """``{name: (us_per_call, derived)}`` of a CSV printout, and the
    ``bench/<name>/wall`` lines as ``{name: seconds}``."""
    rows, walls = {}, {}
    for line in text.splitlines()[1:]:
        name, us, derived = line.split(",", 2)
        if name.startswith("bench/") and name.endswith("/wall"):
            if derived != "ok":
                fail(f"{name}: {derived}")
            walls[name.split("/")[1]] = float(us) / 1e6
        else:
            rows[name] = (float(us), derived)
    return rows, walls


def derived_field(derived, key):
    return float(dict(kv.split("=", 1) for kv in derived.split(";"))[key])


class SweepLog:
    """Records every ``sweep_latency`` call made while installed (over each
    module's binding of it): its arguments, the paper figure that made it
    (from the stack) and its points."""

    def __init__(self):
        self.calls = []
        self._real = sweep_mod.sweep_latency
        self._sig = inspect.signature(self._real)

    def __enter__(self):
        real, sig, calls = self._real, self._sig, self.calls

        def record(*a, **kw):
            args = sig.bind(*a, **kw)
            args.apply_defaults()
            fig = next((f.function for f in inspect.stack()
                        if f.function in FIG_NAMES), None)
            pts = real(*a, **kw)
            calls.append(dict(args.arguments, figure=fig, points=pts))
            return pts
        self._mods = [m for m in list(sys.modules.values())
                      if getattr(m, "sweep_latency", None) is real]
        for m in self._mods:
            m.sweep_latency = record
        return self

    def __exit__(self, *exc):
        for m in self._mods:
            m.sweep_latency = self._real


def cells_of(call):
    """``(grid cells, host cells)`` of a torch-backend sweep: the scalar
    latencies step on the grid, a mixture's cells on the host's compiled
    loop (``sweep._run_torch_cells``)."""
    k = len(call["thread_candidates"])
    grid = sum(k for L in call["latencies"] if isinstance(L, numbers.Real))
    return grid, k * len(call["latencies"]) - grid


def loop_cell(cache, call, L, n):
    """The loop run's throughput of one cell, from its sweep cache (None
    where that sweep did not cache)."""
    trace, _ = sweep_mod._coerce_trace(call["source"])
    digest = hashlib.sha1(trace.kinds.tobytes() + trace.durs.tobytes()
                          + trace.bounds.tobytes()).hexdigest()
    key = sweep_mod._cache_key(replace(call["cfg"], L_mem=L, n_threads=n),
                               digest, call["n_ops"], call["warmup_ops"],
                               "loop", None)
    r = sweep_mod._cache_load(str(cache / f"{key}.json"))
    return None if r is None else r.throughput


def seed_spread(call, L, n, values, seeds=8):
    """The host loop's own spread at one cell of a recorded sweep: the cell
    at the next ``seeds`` seeds; where ``values`` (card, loop) sit in it."""
    trace, _ = sweep_mod._coerce_trace(call["source"])
    thr = np.array([simulate_compiled(
        replace(call["cfg"], seed=call["cfg"].seed + s, L_mem=L,
                n_threads=n), trace, call["n_ops"],
        call["warmup_ops"]).throughput for s in range(1, seeds + 1)])
    mean, std = float(thr.mean()), float(thr.std(ddof=1))
    return {"reseed_mean": mean, "reseed_rel_std": std / mean,
            "z_card": (values[0] - mean) / std,
            "z_loop": (values[1] - mean) / std}


def _suite_cells(doc_t, doc_l, scenarios, gate=True):
    """Every ``per_thread`` cell of two suite documents, torch against loop,
    under ``grid_tol`` (fleets: ``cluster-torch-vs-loop``); ``gate=False``
    reports the gaps without failing the run."""
    contract = conformance.CONTRACTS["cluster-torch-vs-loop"]
    out, worst = [], {}
    for name, art_t in doc_t["artifacts"].items():
        sc = scenarios[name]
        fleet = sc.cluster_spec() is not None and sc.cluster_spec().n_nodes > 1
        tol = (grid_tol(sc.n_ops, base=contract.throughput_tol,
                        ref_ops=contract.ref_ops) if fleet
               else grid_tol(sc.n_ops))
        w = 0.0
        for rt_, rl in zip(art_t["rows"], doc_l["artifacts"][name]["rows"],
                           strict=True):
            for (n, t), (m, lp) in zip(rt_["per_thread"], rl["per_thread"],
                                       strict=True):
                rel = abs(t - lp) / lp
                if n != m or (gate and rel > tol):
                    fail(f"suite {name} L={rt_['L_us']}us {n} threads: card "
                         f"{t} vs loop {lp} ({rel:.4%} > {tol:.4%})")
                w = max(w, rel)
                out.append(rel)
        worst[name] = {"worst_rel": w, "tolerance": tol,
                       "contract": ("cluster-torch-vs-loop" if fleet
                                    else "torch-vs-loop")}
    return worst, len(out)


def phase_cli():
    """``python -m benchmarks.run_torch`` on the card, through its
    ``main``: the scenario suite (``examples/scenarios``), held cell by cell
    against the suite on ``--backend loop`` (in a process of its own); one
    scenario with ``--artifact``, which must repeat the suite's rows bit for
    bit; and ``--engine lsm --cores 4``, its gaps to the loop reported
    (not gated: ``ROADMAP.md`` C17).
    Both suite documents go through ``tools/check_bench.py``; the diff
    tool's report is printed, not gated (winners may flip within noise)."""
    out = OUT_DIR / "cli"
    out.mkdir(parents=True, exist_ok=True)
    suite = ROOT / "examples" / "scenarios"
    scenarios = {p.stem: Scenario.from_json(p.read_text())
                 for p in sorted(suite.glob("*.json"))}
    windows = {}

    reset_counts()
    text, wall = run_cli(["--suite", suite, "--suite-out",
                          out / "suite_torch.json"])
    windows["suite"] = dict(wall_s=wall, launches=counts())
    reset_counts()
    art_path = out / "hash_index_2ssd.json"
    text_sc, wall = run_cli(["--scenario", suite / "hash_index_2ssd.json",
                             "--artifact", art_path])
    windows["scenario"] = dict(wall_s=wall, launches=counts())
    reset_counts()
    text_eng, wall = run_cli(["--engine", "lsm", "--cores", "4",
                              "--artifact", out / "lsm_cores4_torch.json"])
    windows["engine_lsm_cores4"] = dict(wall_s=wall, launches=counts())
    for name, w in windows.items():
        if w["launches"]["fused_steps"] <= 0:
            fail(f"cli {name}: no fused_steps launch")
        if w["launches"]["token_clock_update"]:
            fail(f"cli {name}: standalone token-clock launches")

    _, _, loop_wall = run_module(
        "benchmarks.run_torch", "--backend", "loop", "--suite", suite,
        "--suite-out", out / "suite_loop.json")
    _, _, eng_loop_wall = run_module(
        "benchmarks.run_torch", "--backend", "loop", "--engine", "lsm",
        "--cores", "4", "--artifact", out / "lsm_cores4_loop.json")
    checked = check_doc(out / "suite_torch.json") + \
        check_doc(out / "suite_loop.json")
    doc_t = json.loads((out / "suite_torch.json").read_text())
    doc_l = json.loads((out / "suite_loop.json").read_text())
    if doc_t["backend"] != "torch" or doc_l["backend"] != "loop":
        fail(f"suite backends {doc_t['backend']}, {doc_l['backend']}")
    worst, n_cells = _suite_cells(doc_t, doc_l, scenarios)
    art = json.loads(art_path.read_text())
    if art["rows"] != doc_t["artifacts"]["hash_index_2ssd"]["rows"]:
        fail("--scenario hash_index_2ssd.json does not repeat the suite's "
             "rows bit for bit")
    eng_t = json.loads((out / "lsm_cores4_torch.json").read_text())
    eng_l = json.loads((out / "lsm_cores4_loop.json").read_text())
    eng_sc = Scenario.from_dict(eng_t["scenario"])
    # reported, not gated: at 16-64 threads a core on 4 cores the
    # reference's own grid misses grid_tol(5000) against the loop too
    # (ROADMAP C17)
    eng_worst, eng_cells = _suite_cells(
        {"artifacts": {"lsm_cores4": eng_t}},
        {"artifacts": {"lsm_cores4": eng_l}}, {"lsm_cores4": eng_sc},
        gate=False)
    diff = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "artifact_diff.py"),
         str(out / "suite_loop.json"), str(out / "suite_torch.json")],
        capture_output=True, text=True, timeout=120)
    total = sum(w["launches"]["fused_steps"] for w in windows.values())
    emit("cli", windows=windows, loop_suite_wall_s=loop_wall,
         loop_engine_wall_s=eng_loop_wall,
         suite_wall_s={e["scenario"]: e["wall_s"] for e in doc_t["index"]},
         suite_cells=n_cells, suite_worst=worst,
         engine_lsm_cores4={"cells": eng_cells, **eng_worst["lsm_cores4"],
                            "gated": False, "note": "ROADMAP C17"},
         scenario_repeats_suite_rows=True, check_bench=checked,
         artifact_diff_rc=diff.returncode,
         artifact_diff=(diff.stdout + diff.stderr).strip().splitlines()[-3:],
         csv_rows=len(text.splitlines()) - 1, launches=total)
    return total


def start_paper_figs_loop():
    """The figures on ``--backend loop`` for :func:`phase_paper_figs`,
    started now in a process of their own (CPU only, their sweep cells
    memoized under ``FIG_LOOP_CACHE``) so that they run beside the
    conformance phase's card work; the returned function waits for them."""
    shutil.rmtree(FIG_LOOP_CACHE, ignore_errors=True)
    return start_module(
        "benchmarks.run_torch", "--backend", "loop", "--device", "cpu",
        "--sweep-cache", FIG_LOOP_CACHE)


def phase_paper_figs(loop_run):
    """Every figure of ``paper_figs_torch.ALL`` and the kernels' rows on the
    card, through ``benchmarks.run_torch``'s default list in this process
    (the wall time of each from its ``bench/*/wall`` row); then every
    figure again on ``--backend loop`` (``loop_run``, started by
    :func:`start_paper_figs_loop`).  Every grid cell of the card's fig11, fig13 and fig15
    sweeps is held within ``grid_tol(n_ops)`` of its loop cell, save the
    figures on record with the exact count and worst gap of their cells
    past it (``_torch_kernel_cases.FIG_KNOWN_MISSES``, ROADMAP C17); each
    figure's worst cell is shown beside the loop's own spread there over 8
    more seeds.  The host-only figures must print the same rows."""
    reset_counts()
    with SweepLog() as log:
        text, wall = run_cli([])
    launches = counts()
    by_instance = {
        "flash_attention": dict(fa.flash_attention.launches_by_instance),
        "paged_decode_attention": dict(
            pk.paged_decode_attention.launches_by_instance),
        "wkv6": dict(wk.wkv6.launches_by_instance)}
    for name in KERNELS:
        if name != "token_clock_update" and launches[name] <= 0:
            fail(f"paper_figs: kernel {name} was not launched")
    if launches["token_clock_update"]:
        fail("paper_figs: standalone token-clock launches")
    rows_t, walls_t = csv_rows(text)
    if sorted(walls_t) != sorted(FIG_NAMES + tuple(
            f.__name__ for f in kbench.ALL) + ("roofline_table",)):
        fail(f"paper_figs: benches run {sorted(walls_t)}")
    for name, (us, derived) in rows_t.items():
        if not math.isfinite(us) or us < 0 or "nan" in derived:
            fail(f"paper_figs row {name}: {us},{derived}")

    loop_out, _, loop_wall = loop_run()
    rows_l, walls_l = csv_rows(loop_out)
    for name, row in rows_l.items():
        if name.startswith(HOST_ROWS) and rows_t.get(name) != row:
            fail(f"host figure row {name} differs between the runs: "
                 f"{rows_t.get(name)} vs {row}")

    # every cell of the card's sweeps against the loop's cache; a cell past
    # grid_tol must be on record with its figure (ROADMAP C17)
    per_fig, compared, worst_cell, call_no = {}, {}, {}, {}
    for call in log.calls:
        fig = call["figure"]
        if call["backend"] != "torch":
            fail(f"{fig}: a sweep on backend {call['backend']!r}")
        k = call_no[fig] = call_no.get(fig, -1) + 1
        g, h = cells_of(call)
        rec = per_fig.setdefault(fig, {"grid_cells": 0, "host_cells": 0,
                                       "sweeps": 0})
        rec["grid_cells"] += g
        rec["host_cells"] += h
        rec["sweeps"] += 1
        tol = grid_tol(call["n_ops"])
        for L, pt in zip(call["latencies"], call["points"]):
            if not isinstance(L, numbers.Real):
                continue
            for n, thr in pt.per_thread.items():
                ref = loop_cell(FIG_LOOP_CACHE, call, L, n)
                if ref is None:
                    continue
                rel = abs(thr - ref) / ref
                c = compared.setdefault(fig, {"cells": 0, "worst_rel": 0.0,
                                              "tolerance": tol,
                                              "over_tolerance": 0})
                c["cells"] += 1
                c["tolerance"] = max(c["tolerance"], tol)
                if rel > tol:
                    c["over_tolerance"] += 1
                if rel >= c["worst_rel"]:
                    c["worst_rel"], worst_cell[fig] = rel, (call, L, n, thr,
                                                            ref, k)
    for fig in ("fig11_microbenchmark", "fig13_engine_matrix"):
        want = per_fig[fig]["grid_cells"]
        if compared.get(fig, {}).get("cells") != want:
            fail(f"{fig}: {compared.get(fig)} cells compared of {want}")
    over = {fig: (c["over_tolerance"], c["worst_rel"])
            for fig, c in compared.items() if c["over_tolerance"]}
    if over != cases.FIG_KNOWN_MISSES:
        fail(f"paper_figs: figures with cells past grid_tol {over}, on "
             f"record {cases.FIG_KNOWN_MISSES} (ROADMAP C17)")
    # each figure's worst cell beside the loop's own spread at that cell
    for fig, (call, L, n, thr, ref, k) in worst_cell.items():
        compared[fig]["worst_cell"] = dict(
            call=k, L_us=L / US, threads=n, card=thr, loop=ref,
            **seed_spread(call, L, n, (thr, ref)))

    def headline(rows):
        out = {}
        for name, (_, d) in rows.items():
            if name == "fig15/geomean_degradation":
                out["fig15_geomean"] = derived_field(d, "geomean")
            elif name.endswith("/degradation_at_10us"):
                out[name] = derived_field(d, "d")
            elif name.endswith("/max_model_err"):
                out[name] = derived_field(d, "max_abs_rel")
            elif name == "table6/flash_tail_degradation":
                out["table6_d"] = derived_field(d, "d")
        return out

    emit("paper_figs", wall_s=wall, loop_wall_s=loop_wall,
         fig_wall_s=walls_t, fig_loop_wall_s=walls_l, launches=launches,
         launches_by_instance=by_instance, cells=per_fig,
         host_figures=list(HOST_FIGS), vs_loop=compared,
         past_grid_tol_on_record=sorted(over),
         headline_card=headline(rows_t), headline_loop=headline(rows_l),
         rows=len(rows_t))
    return launches


def phase_grid_bench():
    """``benchmarks.torch_grid_bench`` at the reference's sizes, every
    suite, nothing cut (``mega``: 4096 cells), in a process of its own (its
    loop side forks its workers before the process touches the card).
    ``validate`` must pass, every entry must launch ``fused_steps``, and
    every entry's worst cell must lie within its ``grid_tol`` save the
    entries on record with their exact figure
    (``_torch_kernel_cases.GRID_BENCH_KNOWN_MISSES``, ROADMAP C17); the
    speed floors are printed, never fatal."""
    path = OUT_DIR / "torch_grid_bench.json"
    _, err, wall = run_module("benchmarks.torch_grid_bench", "--suite",
                              "default,mega,het,smoke", "--out", path)
    doc = json.loads(path.read_text())
    try:
        checked = gbench.validate(doc)
    except ValueError as e:
        fail(f"torch_grid_bench: {e}")
    if doc["summary"]["mega"]["cells"] != 4096:
        fail(f"mega suite cut: {doc['summary']['mega']['cells']} cells")
    for e in doc["entries"]:
        if e["fused_steps_launches"] <= 0:
            fail(f"torch_grid_bench {e['name']}: no fused_steps launch")
    over = {e["name"]: e["worst_rel"] for e in gbench.over_bound(doc)}
    if over != cases.GRID_BENCH_KNOWN_MISSES:
        fail(f"torch_grid_bench: entries past grid_tol {over}, on record "
             f"{cases.GRID_BENCH_KNOWN_MISSES} (ROADMAP C17)")
    floors = gbench.floors(doc)
    for f in floors:
        print(f"chip_smoke: grid_bench floor {f['suite']}: {f['measure']} "
              f"{f['value']:.3f}x (floor {f['floor']}x) "
              f"{'met' if f['met'] else 'MISSED'}", flush=True)
    emit("grid_bench", wall_s=wall, summary=doc["summary"],
         entries=[{k: e[k] for k in (
             "name", "cells", "n_ops", "loop_s", "torch_cold_s",
             "torch_warm_s", "warm_speedup", "worst_rel", "worst_rel_bound",
             "loop_reseed_worst_rel", "fused_steps_launches")}
             for e in doc["entries"]],
         over_bound_on_record=sorted(over),
         het={k: v for k, v in doc["entries"][-2].items()
              if k.startswith(("torch_cohort", "torch_mono", "mono",
                               "cell_steps", "steps_saved"))},
         validate=checked, floors=floors,
         launches=sum(e["fused_steps_launches"] for e in doc["entries"]),
         launches_note="one warm call of each entry, counted in the "
                       "bench's process",
         host=doc["host"], log=[ln for ln in err.splitlines()
                                if ln.startswith("#")])
    return floors


class _Row:
    """The slice of an artifact row the conformance gates read."""

    def __init__(self, e):
        self.tail = {k: e[k] for k in ("p50_us", "p90_us", "p99_us")}
        self.throughput, self.n_threads = e["achieved_load"], e["n_threads"]


def phase_tail_bench():
    """``benchmarks.tail_latency_bench_torch`` ``FULL`` on the card (in this
    process, counted) and on ``--backend loop`` (in a process of its own);
    both documents through ``tools/check_bench.py``.  Capacity within
    ``grid_tol(4000)``; p50 / p99 of each point held to the conformance
    harness's own ``torch-vs-loop`` tail bounds and gates (its p50 gate for
    bimodal sojourns, its queueing gate)."""
    reset_counts()
    t0 = time.perf_counter()
    doc_t = tbench.document(tbench.FULL, "torch", DEV)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts()
    if launches["fused_steps"] <= 0 or launches["token_clock_update"]:
        fail(f"tail_bench launches: {launches}")
    path_t = OUT_DIR / "tail_latency_bench_torch.json"
    path_l = OUT_DIR / "tail_latency_bench_loop.json"
    path_t.write_text(json.dumps(doc_t, indent=2) + "\n")
    _, _, loop_wall = run_module("benchmarks.tail_latency_bench_torch",
                                 "--backend", "loop", "--out", path_l)
    checked = check_doc(path_t) + check_doc(path_l)
    doc_l = json.loads(path_l.read_text())
    n_ops = tbench.FULL["n_ops"]
    name = tbench.FULL["name"]
    cap_t, cap_l = (d["summary"][name]["capacity"] for d in (doc_t, doc_l))
    cap_rel, cap_tol = abs(cap_t - cap_l) / cap_l, grid_tol(n_ops)
    if cap_rel > cap_tol:
        fail(f"tail_bench capacity: card {cap_t} vs loop {cap_l} "
             f"({cap_rel:.4%} > {cap_tol:.4%})")
    contract = conformance.CONTRACTS["torch-vs-loop"]
    bounds = {f: tail_tol(n_ops, base=getattr(contract, f"{f}_tol"),
                          ref_ops=contract.tail_ref_ops,
                          slack=conformance.FUZZ_TAIL_SLACK)
              for f in ("p50", "p99")}
    points, misses = [], []
    for et, el in zip(doc_t["entries"], doc_l["entries"], strict=True):
        if (et["L_us"], et["offered_frac"]) != (el["L_us"],
                                                el["offered_frac"]):
            fail("tail_bench: the two documents' points differ")
        gated = conformance._queueing_dominated(_Row(el), 1)
        fails = [] if gated else conformance._tail_fails(
            _Row(el).tail, _Row(et).tail, p50_tol=bounds["p50"],
            p99_tol=bounds["p99"], check="tail_bench",
            contract=contract.name, label=f"L={et['L_us']}us "
            f"@{et['offered_frac']}", sc=None)
        misses += [f.message for f in fails]
        points.append({
            "L_us": et["L_us"], "offered_frac": et["offered_frac"],
            "offered_card": et["offered_load"],
            "offered_loop": el["offered_load"],
            "achieved_card": et["achieved_load"],
            "achieved_loop": el["achieved_load"],
            **{f"{f}_{s}": d[f"{f}_us"] for f in ("p50", "p99")
               for s, d in (("card", et), ("loop", el))},
            **{f"{f}_rel": conformance._rel(el[f"{f}_us"], et[f"{f}_us"])
               for f in ("p50", "p99")},
            "queueing_gated": gated})
    if misses:
        fail(f"tail_bench tails off the torch-vs-loop bound: {misses}")
    emit("tail_bench", wall_s=wall, loop_wall_s=loop_wall,
         launches=launches, capacity_card=cap_t, capacity_loop=cap_l,
         capacity_rel=cap_rel, capacity_tol=cap_tol, tail_bounds=bounds,
         points=points, check_bench=checked,
         sources=[doc_t["entries"][0]["source"],
                  doc_l["entries"][0]["source"]])
    return launches


def phase_examples():
    """``examples/kvstore_demo_torch.py``, ``serve_tiered_kv_torch.py`` and
    ``quickstart_torch.py`` on the card, each through its ``main`` in a
    counted window; a non-zero exit or an exception fails the run."""
    out = {}
    for name, want in (("kvstore_demo_torch", "fused_steps"),
                       ("serve_tiered_kv_torch", "paged_decode_attention"),
                       ("quickstart_torch", "paged_decode_attention")):
        spec = importlib.util.spec_from_file_location(
            name, ROOT / "examples" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        buf = io.StringIO()
        reset_counts()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(buf):
                mod.main(["--device", "cuda"])
        except SystemExit as e:
            if e.code not in (None, 0):
                fail(f"examples/{name}.py exited {e.code!r}:\n"
                     f"{buf.getvalue()[-2000:]}")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = counts()
        if launches[want] <= 0:
            fail(f"examples/{name}.py launched no {want}")
        out[name] = dict(wall_s=wall, launches=launches,
                         stdout=buf.getvalue().splitlines())
    if "on cuda)" not in out["serve_tiered_kv_torch"]["stdout"][0]:
        fail(f"serve example: {out['serve_tiered_kv_torch']['stdout'][0]}")
    quick = out["quickstart_torch"]["stdout"]
    if quick[-1] != "quickstart OK" or not any(
            "finite=True (on cuda)" in ln for ln in quick):
        fail(f"quickstart: {quick[-4:]}")
    emit("examples", **out)
    return {k: v["launches"] for k, v in out.items()}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the served model's weights and prompts, "
                         "and of the kernel checks' and bench's inputs at "
                         "full width")
    ap.add_argument("--resume-check", metavar="DIR",
                    help="only the training example's resume check, "
                         "checkpointing into DIR (run by the train_example "
                         "phase in a process of its own)")
    ap.add_argument("--dryrun-1x1", metavar="OUT",
                    help="only the dry run's count of the 1x1 training "
                         "cell, written to OUT (run by the dryrun_path "
                         "phase in a process of its own)")
    args = ap.parse_args()
    if args.resume_check:
        resume_check(args.resume_check)
        return
    if args.dryrun_1x1:
        dryrun_one(args.dryrun_1x1)
        return
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
    plain_launches, plain_wall_s = phase_plain_step_path(art)
    phase_agreement(sc, art)
    cluster_launches = phase_cluster_path(art)
    phase_cluster_bench()
    figs_loop = start_paper_figs_loop()
    tc_count = start_token_clock_count()
    phase_conformance()
    cohorts, us = plan_main(sc, art)
    floor_ms, split = phase_sched_split(cohorts, us)
    group, err_main = phase_timing(cohorts, us, floor_ms)
    widest = cohorts[-1]
    tok = phase_token_clock(widest.G, widest.state[6].shape[1]
                            if len(widest.state) > 6 else 1, plain_wall_s,
                            tc_count)
    tok["launches"] = plain_launches["token_clock_update"]
    tok["path"] = "plain_step_path"
    tok["launches_main_path"] = launches["token_clock_update"]
    tok["launches_cluster_path"] = cluster_launches["token_clock_update"]
    fused = dict(
        name="sched_step.fused_steps", route="cuda",
        source="src/repro_torch/kernels/csrc/sched_step.cu",
        replaces="src/repro/kernels/sched_step.py:622",
        launches=launches["fused_steps"], path="main_path",
        launches_cluster_path=cluster_launches["fused_steps"],
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
    torch.cuda.empty_cache()

    families = phase_model_families(args.seed)
    rw = next(f for f in families if f["arch"] == "rwkv6-3b")
    wkv["model_shape"] = {
        name: {k: m[k] for k in ("shape", "chunk", "ms", "ms_turns",
                                 "bound_ms", "bound_by", "checks")}
        for name, m in rw["wkv_model_shape"].items()}
    wkv["model_shape"]["plain"] = "models.rwkv6.wkv_chunked (float32)"

    # training: qwen2.5-3b at full width, the same on a 1x1 mesh, then the
    # training example
    train = phase_train_path(args.seed)
    torch.cuda.empty_cache()
    phase_dist_path(args.seed, train, sc, art)
    del train
    torch.cuda.empty_cache()
    phase_dryrun_path(args.seed)
    phase_train_example()
    torch.cuda.empty_cache()

    # the system's own entry points, each phase in a counted window
    cli_launches = phase_cli()
    figs_launches = phase_paper_figs(figs_loop)
    phase_grid_bench()
    tail_launches = phase_tail_bench()
    example_launches = phase_examples()
    fused["launches_entry_points"] = {
        "cli": cli_launches, "paper_figs": figs_launches["fused_steps"],
        "tail_bench": tail_launches["fused_steps"],
        "kvstore_demo_torch": example_launches[
            "kvstore_demo_torch"]["fused_steps"],
        "grid_bench": "one warm call an entry, in its own process: "
                      "see the grid_bench phase"}
    for entry, name in ((paged, "paged_decode_attention"),
                        (flash, "flash_attention"), (wkv, "wkv6")):
        entry["launches_paper_figs"] = figs_launches[name]
    paged["launches_serve_example"] = example_launches[
        "serve_tiered_kv_torch"]["paged_decode_attention"]
    paged["launches_quickstart_example"] = example_launches[
        "quickstart_torch"]["paged_decode_attention"]

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
