"""The port's CUDA kernels on a card -- the tests that need an NVIDIA GPU:
the scheduler kernels bit-equal to their plain versions, paged decode
attention within ``PAGED_TOL`` of its plain version, a small serving run
through the paged kernel, and flash attention and wkv6 within the
reference's tolerance of their plain versions (and, in bf16, of each row's
norm).

They import the port only (no jax), so they run on the GPU machine with::

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Without a CUDA device every test here skips.  ``chip_smoke.py`` runs the same
comparisons as part of its own checks.
"""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.engines import run_trace
from repro_torch.core.experiment import Experiment, Scenario
from repro_torch.core.sim import SimConfig
from repro_torch.core.sim import replay_torch as rt
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops as kops
from repro_torch.kernels import paged_kv_gather as pk
from repro_torch.kernels import sched_step as sk
from repro_torch.kernels import token_clock as tc
from repro_torch.kernels import wkv6 as wk
from repro_torch.kernels.ref import (flash_attention_ref,
                                     paged_decode_attention_ref, wkv6_ref)

import _torch_kernel_cases as cases

pytestmark = pytest.mark.requires_cuda

US = 1e-6


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def small_trace():
    doc = json.loads((Path(__file__).resolve().parents[1] / "examples"
                      / "scenarios" / "hash_index_2ssd.json").read_text())
    doc.update(n_keys=2000, n_wl_ops=600)
    sc = Scenario.from_dict(doc)
    store, wl = Experiment(sc).build()
    return run_trace(store, wl, warmup_frac=sc.warmup_frac).trace


@pytest.mark.parametrize("name", sorted(cases.FLAG_SETS))
def test_fused_kernel_matches_plain_version(cuda, small_trace, name):
    """Bit-equal planes (histogram: adjacent-bin rule) after 192 steps."""
    case = cases.make_case(small_trace, cases.FLAG_SETS[name], 17,
                           n_steps=192)
    before = sk.fused_steps.launches
    plain = cases.run_plain(case, cuda)
    fused = cases.run_fused(case, cuda)
    torch.cuda.synchronize()
    assert sk.fused_steps.launches == before + 1
    ok, err, bad = cases.states_agree(plain, fused, case["has_lat"])
    assert ok, f"{name}: plane {bad} differs (max abs err {err})"


@pytest.mark.parametrize("name", sorted(cases.FLAG_SETS))
def test_grouped_launch_matches_plain_version_per_cohort(cuda, small_trace,
                                                         name):
    """Three cohorts in one launch -- T 5 / 40 / 70 per core, the NS 1 / 2 /
    4 bodies (2 / 4 / 8 with two cores) -- one leaving after 64 steps and
    one after 128: every cohort bit-equal to the plain version run alone."""
    g = cases.make_group_case(small_trace, cases.FLAG_SETS[name], 29,
                              n_steps=192)
    steps = (192, 64, 128)
    before = sk.fused_steps.launches
    plain = cases.run_group_plain(g, cuda, steps)
    fused = cases.run_group_fused(g, cuda, steps, block=64)
    torch.cuda.synchronize()
    assert sk.fused_steps.launches == before + 3
    for c, a, b in zip(g["cohorts"], plain, fused):
        ok, err, bad = cases.states_agree(a, b, c["has_lat"])
        assert ok, f"{name}, T={c['state'][2].shape[1]}: plane {bad} " \
            f"differs (max abs err {err})"


@pytest.mark.parametrize("name", ["plain", "rio+bio-2ssd", "2cores",
                                  "open-loop+pct+deadline"])
def test_profiling_instance_bit_equal_to_normal_instance(cuda, small_trace,
                                                         name):
    """The profiling instance leaves every plane as the normal one does,
    bit for bit, and its buffer holds a consistent split."""
    g = cases.make_group_case(small_trace, cases.FLAG_SETS[name], 31,
                              n_steps=128)
    steps = (128, 64, 128)
    normal = cases.run_group_fused(g, cuda, steps)
    timed, profs = cases.run_group_fused(g, cuda, steps, profile=True)
    torch.cuda.synchronize()
    for a, b in zip(normal, timed):
        ok, err, bad = cases.states_agree(a, b, False)
        assert ok, f"{name}: plane {bad} differs (max abs err {err})"
    n_ph = len(sk.PROF_PHASES)
    for prof, block_cells in zip(profs, (6, 6)):
        p = prof.cpu().numpy()
        assert p.shape[1] == len(sk.PROF_COLUMNS)
        assert (p[:, :n_ph] >= 0).all() and (p[:, :n_ph].sum(1) > 0).all()
        assert (p[:, :n_ph].sum(1) <= p[:, -1]).all()
        assert (p[:, n_ph] <= 64).all()          # idle skips <= steps


def test_grid_steps_every_cohort_in_one_launch(cuda, small_trace):
    """Three cohorts of a grid, run to their bounds: one launch a chunk."""
    cfg = SimConfig(P=12, seed=7, n_ssd=2, R_io=250e3, L_switch=0.3 * US)
    before = sk.fused_steps.launches
    grid = rt.sweep_grid(cfg, small_trace, [1 * US, 5 * US], [3, 8, 20],
                         n_ops=150, device=cuda, early_exit=False)
    assert sk.fused_steps.launches - before == grid.steps // 1024
    cpu = rt.sweep_grid(cfg, small_trace, [1 * US, 5 * US], [3, 8, 20],
                        n_ops=150, device="cpu")
    assert np.array_equal(grid.throughput, cpu.throughput)


def test_token_clock_kernel_matches_plain_version(cuda):
    rng = np.random.default_rng(5)
    G, S = 300, 3

    def t(a):
        return torch.from_numpy(a).to(cuda)

    submit = t(rng.random(G))
    mask = t((np.arange(S)[None, :] == rng.integers(0, S, G)[:, None])
             & (rng.random(G) < 0.7)[:, None])
    tok, bw = t(rng.random((G, S))), t(rng.random((G, S)))
    before = tc.token_clock_update.launches
    for inv_r, cost in ((0.5, 0.0), (0.5, 0.25), (0.0, 0.25), (0.0, 0.0)):
        got = tc.token_clock_update(submit, mask, tok, bw, inv_r, cost)
        want = tc.token_clock_update_ref(submit, mask, tok, bw, inv_r, cost)
        for a, b in zip(got, want):
            assert torch.equal(a.view(torch.int64), b.view(torch.int64))
    assert tc.token_clock_update.launches == before + 4


@pytest.mark.parametrize("S,mask_dtype,offset,want", [
    (1, torch.bool, 0, "s1"), (2, torch.bool, 0, "s2"),
    (4, torch.bool, 0, "s4"), (8, torch.bool, 0, "s8"),
    (3, torch.bool, 0, "generic"), (64, torch.bool, 0, "generic"),
    (2, torch.int32, 0, "generic"), (2, torch.int64, 0, "generic"),
    (2, torch.bool, 1, "generic")],
    ids=["s1", "s2", "s4", "s8", "S3", "S64", "int32", "int64", "unaligned"])
def test_token_clock_instances_bit_equal_one_launch_a_call(
        cuda, S, mask_dtype, offset, want):
    """Each instance of the kernel bit-equal to the plain version, each
    clock on and off; one kernel a call (no cast launch: the mask is read
    as given), counted by ``torch.profiler``.  ``offset`` starts the clock
    planes one double into their buffers (rows not 16-byte aligned)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(S)
    G = 300

    def clocks():
        buf = torch.from_numpy(rng.random(G * S + offset)).to(cuda)
        return buf[offset:].view(G, S)

    submit = torch.from_numpy(rng.random(G)).to(cuda)
    mask = torch.from_numpy(
        (np.arange(S)[None, :] == rng.integers(0, S, G)[:, None])
        & (rng.random(G) < 0.7)[:, None]).to(cuda).to(mask_dtype)
    tok, bw = clocks(), clocks()
    assert tc.instance(mask, tok, bw) == want
    for inv_r, cost in ((0.5, 0.0), (0.5, 0.25), (0.0, 0.25), (0.0, 0.0)):
        before = dict(tc.token_clock_update.launches_by_instance)
        got = tc.token_clock_update(submit, mask, tok, bw, inv_r, cost)
        ref = tc.token_clock_update_ref(submit, mask, tok, bw, inv_r, cost)
        after = tc.token_clock_update.launches_by_instance
        assert {k: after[k] - before[k] for k in after
                if after[k] != before[k]} == {want: 1}
        for a, b in zip(got, ref):
            assert torch.equal(a.view(torch.int64), b.view(torch.int64))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            tc.token_clock_update(submit, mask, tok, bw, 0.5, 0.25)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events()
               if e.device_type == DeviceType.CUDA]
    assert len(kernels) == 5 and all("token_clock" in k for k in kernels), \
        kernels


def test_grid_kernel_path_bit_identical_to_plain_path(cuda, small_trace):
    """The whole grid: fused kernel vs plain step on the card, same draws."""
    cfg = SimConfig(P=12, seed=7, n_ssd=2, R_io=250e3, L_switch=0.3 * US)
    kw = dict(n_ops=150, device=cuda)
    fused = rt.sweep_grid(cfg, small_trace, [1 * US, 5 * US], [4, 8], **kw)
    plain = rt.sweep_grid(cfg, small_trace, [1 * US, 5 * US], [4, 8],
                          use_kernel=False, **kw)
    for fld in ("throughput", "time", "mem_stall_total", "mem_accesses"):
        assert np.array_equal(getattr(fused, fld), getattr(plain, fld)), fld
    cpu = rt.sweep_grid(cfg, small_trace, [1 * US, 5 * US], [4, 8],
                        n_ops=150, device="cpu")
    assert np.array_equal(fused.throughput, cpu.throughput)


def test_sweep_spans_on_the_device_trace_clock(cuda, small_trace, tmp_path):
    """One small sweep profiled with CPU and CUDA activity: the runtime call
    that launched each ``sched_step_kernel`` lies inside a ``grid.launch``
    span of the export, so the spans share the device trace's clock.  A
    session with CUDA activity alone records the same span tree."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import obs
    from repro_torch.core.sim import sweep_latency

    cfg = SimConfig(P=12, seed=7, n_ssd=2, R_io=250e3, L_switch=0.3 * US)

    def sweep():
        sweep_latency(cfg, small_trace, [1 * US, 5 * US], [4, 8, 20],
                      n_ops=150, backend="torch", device=cuda)
        torch.cuda.synchronize()

    sweep()                                          # build, warm up
    obs.clear()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        sweep()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X"]
    spans = [e for e in events if e.get("cat") == "user_annotation"
             and e["name"] == "grid.launch"]
    calls = {e["args"]["correlation"]: e for e in events     # CUDA API
             if e.get("cat", "").startswith("cuda_")
             and "correlation" in e.get("args", {})}
    kernels = [e for e in events if e.get("cat") == "kernel"
               and "sched_step_kernel" in e["name"]]
    (both,) = obs.frames()
    assert kernels and len(spans) == len(kernels) == sum(
        s.name == "grid.launch" for s in both.spans)
    for k in kernels:
        c = calls[k["args"]["correlation"]]
        assert any(s["ts"] <= c["ts"] and c["ts"] + c["dur"]
                   <= s["ts"] + s["dur"] for s in spans), c
    obs.clear()
    with profile(activities=[ProfilerActivity.CUDA]):
        sweep()
    (cuda_only,) = obs.frames()
    assert [s.name for s in cuda_only.spans] == [s.name for s in both.spans]
    assert cuda_only.counters == both.counters
    obs.clear()


# -- the fleet and the corpus on the card --------------------------------------

CORPUS = sorted((Path(__file__).resolve().parents[1] / "examples"
                 / "conformance").glob("*.json"))


@pytest.mark.parametrize("path", CORPUS, ids=lambda p: p.stem)
def test_corpus_kernel_vs_plain_on_the_card(cuda, path):
    """``torch-kernel-vs-plain`` on every corpus scenario: the fused kernel
    and the plain step give the same rows (the conformance ``kernel``
    check, one clipped cell)."""
    from repro_torch.core import conformance

    sc = Scenario.from_json(path.read_text())
    fails = conformance.check_scenario(sc, ("kernel",), device=cuda)
    assert not fails, [str(f) for f in fails]


def test_fleet_node_grids_kernel_bit_equal_to_plain_step(cuda, monkeypatch):
    """A 4-node fleet (hash partition, replication 2 with spread reads, a
    5 us route hop, a degraded node, Poisson arrivals with a deadline):
    each node's grid through the fused kernel is bit-equal to its grid
    through the plain step on the card, node by node."""
    from repro_torch.core.experiment import RunOptions

    doc = json.loads((Path(__file__).resolve().parents[1] / "examples"
                      / "scenarios" / "cluster_hot_shard.json").read_text())
    doc.update(n_ops=300, latencies_us=[1.0, 5.0], thread_candidates=[8, 16],
               cluster=dict(doc["cluster"], node_overrides={
                   "2": {"io_degrade": 4.0, "T_degrade_us": 300.0}}))
    grids = {True: [], False: []}
    real = rt.sweep_grid

    def record(cfg, trace, *a, use_kernel=None, **kw):
        g = real(cfg, trace, *a, use_kernel=use_kernel, **kw)
        grids[use_kernel].append(g)
        return g

    monkeypatch.setattr(rt, "sweep_grid", record)
    rows = {}
    for use_kernel in (True, False):
        rows[use_kernel] = Experiment(Scenario.from_dict(doc), RunOptions(
            device=cuda, use_kernel=use_kernel,
            collect_percentiles=True)).run().rows
    assert len(grids[True]) == len(grids[False]) == 4
    for g, p in zip(grids[True], grids[False]):
        for fld in ("throughput", "time", "mem_stall_total", "mem_accesses",
                    "lat_max", "missed", "lat_count"):
            assert np.array_equal(getattr(g, fld), getattr(p, fld)), fld
        for a, b in zip(g.lat_hist.reshape(-1, g.lat_hist.shape[-1]),
                        p.lat_hist.reshape(-1, p.lat_hist.shape[-1])):
            assert cases.hist_equal_or_adjacent(a[None], b[None])
    for a, b in zip(rows[True], rows[False]):
        assert a.per_thread == b.per_thread
        assert [n["share"] for n in a.nodes] == [n["share"] for n in b.nodes]


# -- paged decode attention ----------------------------------------------------

PAGED = {f"paged-{i}": c for i, c in enumerate(cases.PAGED_CASES)}
PAGED["edge-len1-full"] = cases.PAGED_EDGE
PAGED["serve-shape"] = cases.PAGED_SERVE


@pytest.mark.parametrize("n_buffers", [2, 3, 4])
@pytest.mark.parametrize("name", sorted(PAGED))
def test_paged_kernel_matches_plain_version(cuda, name, n_buffers):
    c = cases.make_paged_case(PAGED[name], seed=1)
    args = cases.paged_tensors(c, cuda)
    before = pk.paged_decode_attention.launches
    got = kops.paged_decode_attention(*args, n_buffers=n_buffers)
    want = paged_decode_attention_ref(*args)
    torch.cuda.synchronize()
    assert pk.paged_decode_attention.launches == before + 1
    assert got.dtype == want.dtype and got.shape == want.shape
    err = float((got.float() - want.float()).abs().max())
    assert err <= cases.PAGED_TOL[c["dtype"]], err


def _paged_run(args, dtype, **kw):
    """One launch, checked against the plain version (absolute and relative
    to each row); returns the output and checks that the instance of
    ``dtype`` counted it."""
    inst = pk.instance_for(getattr(torch, dtype))
    before = dict(pk.paged_decode_attention.launches_by_instance)
    got = pk.paged_decode_attention(*args, **kw)
    want = paged_decode_attention_ref(*args)
    torch.cuda.synchronize()
    after = pk.paged_decode_attention.launches_by_instance
    assert after == {**before, inst: before[inst] + 1}
    err = float((got.float() - want.float()).abs().max())
    assert bool(torch.isfinite(got).all())
    assert err <= cases.PAGED_TOL[dtype], err
    row = cases.row_rel_err(got, want)
    assert row <= cases.PAGED_ROW_TOL, row
    return got


@pytest.mark.parametrize("n_buffers", [2, 3, 4])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("name", sorted(PAGED))
def test_paged_both_instances_match_plain_version(cuda, name, dtype,
                                                  n_buffers):
    """Every case in both dtypes: ``mma_bf16`` and ``scalar_f32``."""
    c = cases.make_paged_case(PAGED[name], seed=1)
    _paged_run(cases.paged_tensors(c, cuda, dtype), dtype,
               n_buffers=n_buffers)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("name", sorted(cases.PAGED_SPLIT_CASES))
def test_paged_forced_splits_match_and_repeat(cuda, name, dtype):
    """Forced split counts (1, 2, 3, more than pages), lengths 0 and 1,
    mid-page ends, rep 12 and 16, D 32: within tolerance, and bit for bit
    the same on a second run (the merge's order is fixed)."""
    case = cases.PAGED_SPLIT_CASES[name]
    c = cases.make_paged_case(case, seed=1)
    args = cases.paged_tensors(c, cuda, dtype)
    kw = dict(n_splits=case["n_splits"])
    plan = pk.launch_plan(*args, **kw)
    if case["n_splits"] is not None:
        assert plan["n_splits"] == case["n_splits"]
    first = _paged_run(args, dtype, **kw)
    second = _paged_run(args, dtype, **kw)
    assert torch.equal(first, second)
    for b, n in enumerate(c["lengths"]):
        if n == 0:
            assert not bool(first[b].any())


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("i", range(len(cases.PAGED_CASES)))
def test_paged_kernel_reads_out_of_store_ids_as_plain_version(cuda, i,
                                                              dtype):
    """Page ids ``P + 2``, ``-1``, ``-(P + 3)`` inside and past each
    sequence's pages: wrapped once, then clamped, as the plain version."""
    c = cases.with_bad_page_ids(cases.make_paged_case(cases.PAGED_CASES[i],
                                                      seed=6))
    for n_splits in (None, 1, 3):
        _paged_run(cases.paged_tensors(c, cuda, dtype), dtype,
                   n_splits=n_splits)


def test_paged_kernel_refuses_what_it_does_not_take(cuda):
    c = cases.make_paged_case(cases.PAGED_CASES[0], seed=2)
    q, k, v, bt, ln = cases.paged_tensors(c, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        pk.paged_decode_attention(q, k.transpose(1, 2).contiguous()
                                  .transpose(1, 2), v, bt, ln)
    with pytest.raises(ValueError, match="dtype"):
        pk.paged_decode_attention(q.half(), k.half(), v.half(), bt, ln)
    with pytest.raises(ValueError, match="shared memory"):
        big = torch.zeros(4, 256, 2, 64, device=cuda)
        pk.paged_decode_attention(q, big, big, bt, ln)


def test_serve_engine_on_the_card_agrees_with_the_dense_path(cuda):
    """A smoke-size engine on the card: every decode step goes through the
    kernel (n_layers launches a step), and its logits stay within
    ``MODEL_TOL`` of the dense path teacher-forced on the same tokens."""
    from repro_torch.configs import ARCHS, smoke_config
    from repro_torch.models import transformer as tf
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = smoke_config(ARCHS["qwen2.5-3b"]).replace(sliding_window=None)
    eng = ServeEngine(cfg, n_pages=32, page_size=8, max_slots=1, seed=0,
                      device=cuda)
    prompt = np.arange(1, 12, dtype=np.int32)
    req = Request(rid=0, prompt=prompt, max_new_tokens=6)
    eng.submit(req)
    before = pk.paged_decode_attention.launches
    paged = []
    while eng.waiting or eng.active:
        eng.step()
        paged.append(eng.last_decode[1][0].float())
    assert len(paged) == 5 and len(req.out_tokens) == 6
    assert pk.paged_decode_attention.launches - before == 5 * cfg.n_layers
    assert len(eng.cache.free) == 32
    _, cache = tf.prefill(eng.params, torch.from_numpy(prompt).to(cuda)[None],
                          cfg, max_len=len(prompt) + 6)
    for t in range(5):
        tok = torch.tensor([[req.out_tokens[t]]], device=cuda)
        logits, cache = tf.decode_step(eng.params, cache, tok, cfg)
        err = float((logits[0, 0].float() - paged[t]).abs().max())
        assert err <= cases.MODEL_TOL, (t, err)


# -- flash attention and wkv6 --------------------------------------------------


@pytest.mark.parametrize("case", cases.FLASH_CASES + [cases.FLASH_LONG],
                         ids=[f"flash-{i}" for i in range(6)] + ["long-4096"])
def test_flash_kernel_matches_plain_version(cuda, case):
    c = cases.make_flash_case(case, seed=0)
    q, k, v = cases.flash_tensors(c, cuda)
    before = fa.flash_attention.launches
    got = kops.flash_attention(q, k, v, causal=c["causal"],
                               sliding_window=c["window"],
                               block_q=c["block_q"], block_k=c["block_k"])
    want = flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), c["causal"],
                               c["window"]).transpose(1, 2)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    assert got.dtype == want.dtype and got.shape == want.shape
    err = float((got.float() - want.float()).abs().max())
    assert err <= cases.tol(c["dtype"]), err
    assert cases.row_rel_err(got, want) <= cases.FLASH_ROW_TOL


@pytest.mark.parametrize("case", cases.FLASH_TC_CASES,
                         ids=[f"tc-{i}" for i in
                              range(len(cases.FLASH_TC_CASES))])
def test_flash_tensor_core_instance_matches_plain_version(cuda, case):
    """Every layout of the ``wgmma_bf16`` instance (head_dims, masks, GQA
    groups, ragged S): 3e-2 absolute and ``FLASH_ROW_TOL`` per row."""
    c = cases.make_flash_case(case, seed=0)
    q, k, v = cases.flash_tensors(c, cuda)
    before = dict(fa.flash_attention.launches_by_instance)
    got = kops.flash_attention(q, k, v, causal=c["causal"],
                               sliding_window=c["window"],
                               block_q=c["block_q"], block_k=c["block_k"])
    want = flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), c["causal"],
                               c["window"]).transpose(1, 2)
    torch.cuda.synchronize()
    after = fa.flash_attention.launches_by_instance
    assert after["wgmma_bf16"] == before["wgmma_bf16"] + 1
    assert after["scalar_f32"] == before["scalar_f32"]
    assert bool(torch.isfinite(got).all())
    err = float((got.float() - want.float()).abs().max())
    assert err <= cases.tol("bfloat16"), err
    assert cases.row_rel_err(got, want) <= cases.FLASH_ROW_TOL


def test_flash_kernel_takes_strided_head_major_views(cuda):
    """The reference's tests hand the kernel transposed arrays; so may a
    caller here."""
    c = cases.make_flash_case(cases.FLASH_CASES[0], seed=1)
    q, k, v = cases.flash_tensors(c, cuda, head_major=False)
    got = kops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2))
    want = flash_attention_ref(q, k, v).transpose(1, 2)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= cases.tol("float32")


def _wkv_case_holds(args, chunk, dtype):
    """One wkv6 call against the plain version: one launch of the instance
    of its dtype, the scaled tolerance and ``WKV_ROW_TOL`` of each row,
    finite, and the same bits again and with the caller's chunk 1."""
    before = dict(wk.wkv6.launches_by_instance)
    got = kops.wkv6(*args, chunk=chunk)
    want = wkv6_ref(*args)
    torch.cuda.synchronize()
    inst = wk.instance_for(getattr(torch, dtype))
    assert wk.wkv6.launches_by_instance == {
        **before, inst: before[inst] + 1}
    assert got.dtype == want.dtype and got.shape == want.shape
    assert bool(torch.isfinite(got).all())
    assert cases.wkv_err(got, want) <= cases.tol(dtype)
    assert cases.row_rel_err(got, want) <= cases.WKV_ROW_TOL
    assert torch.equal(kops.wkv6(*args, chunk=chunk), got)
    assert torch.equal(kops.wkv6(*args, chunk=1), got)


@pytest.mark.parametrize("case", cases.WKV_CASES,
                         ids=[f"wkv-{i}" for i in range(4)])
def test_wkv6_kernel_matches_plain_version(cuda, case):
    c = cases.make_wkv_case(case, seed=0)
    _wkv_case_holds(cases.wkv_tensors(c, cuda), c["chunk"], c["dtype"])


@pytest.mark.parametrize("case", cases.WKV_TC_CASES,
                         ids=[f"tc-{i}" for i in
                              range(len(cases.WKV_TC_CASES))])
def test_wkv6_tensor_core_instance_matches_plain_version(cuda, case):
    """Both head_dims, log_w in bf16 and float32, ragged S, B > 1, long S,
    callers' chunks of 1 to 96: ``chunk_tc_bf16``."""
    c = cases.make_wkv_case(case, seed=0)
    _wkv_case_holds(cases.wkv_tensors(c, cuda), c["chunk"], c["dtype"])


@pytest.mark.parametrize("decay", cases.WKV_DECAYS)
@pytest.mark.parametrize("w_dtype", ["float32", "bfloat16"])
def test_wkv6_tensor_core_instance_under_strong_decays(cuda, decay, w_dtype):
    c = cases.make_wkv_case((2, 1024, 2, 64, 32, "bfloat16", w_dtype),
                            seed=1, decay=decay)
    _wkv_case_holds(cases.wkv_tensors(c, cuda), c["chunk"], c["dtype"])


def test_flash_and_wkv6_kernels_refuse_what_they_do_not_take(cuda):
    c = cases.make_flash_case(cases.FLASH_CASES[0], seed=2)
    q, k, v = cases.flash_tensors(c, cuda)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(q[..., :48], k[..., :48], v[..., :48])
    with pytest.raises(ValueError, match="dtype"):
        fa.flash_attention(q.half(), k.half(), v.half())
    w = cases.make_wkv_case(cases.WKV_CASES[0], seed=2)
    r, kk, vv, lw, u = cases.wkv_tensors(w, cuda)
    with pytest.raises(ValueError, match="chunk multiple"):
        wk.wkv6(r[:, :60], kk[:, :60], vv[:, :60], lw[:, :60], u, chunk=16)
    z = torch.zeros(1, 8, 2, 48, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="not taken by chunk_tc_bf16"):
        wk.wkv6(z, z, z, z.float(), torch.zeros(2, 48, device=cuda))
