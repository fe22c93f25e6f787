"""The grouped launch of the port's scheduler step: every cohort of a grid in
one ``fused_steps_group`` launch, and the chunk loop that drives it.

On the CPU the wrapper runs the plain step, so these tests hold what
surrounds the kernel: the grouped chunk loop (one uniform draw and one launch
per chunk for all live cohorts, each cohort leaving at its own bound or
latch) against the cohorts run one by one and against the reference's grid
under its own draws; the concatenated uniform draw against the per-cohort
blocks; and the pure-Python builder of the kernel's argument block against
the C struct it mirrors.  The kernel itself is held against the plain
version on the card in ``test_torch_cuda.py``.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.sim import SimConfig
from repro_torch.core.sim import replay_torch as rt
from repro_torch.kernels import sched_step as sk

import _torch_kernel_cases as cases
from _torch_port_support import US, bits_equal, engine_trace
from test_torch_replay import ReferenceDraws, _reference_grid

CSRC = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
        / "kernels" / "csrc" / "sched_step.cu")
CFG = dict(P=12, seed=7, n_ssd=2, R_io=250e3, L_switch=0.3 * US)
LATS = [0.5 * US, 5 * US]


@pytest.fixture(scope="module")
def hash_small():
    return engine_trace("hash-index").trace


@pytest.fixture(scope="module")
def hash_small_ref():
    return engine_trace("hash-index", port=False).trace


def _outs_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert bits_equal(np.asarray(a[k]), np.asarray(b[k])), k


# -- the grouped chunk loop ----------------------------------------------------


@pytest.mark.parametrize("early_exit", [True, False])
@pytest.mark.parametrize("bucket_threads", [True, False])
def test_grouped_chunk_loop_equals_cohorts_one_by_one(
        monkeypatch, hash_small, bucket_threads, early_exit):
    """One chunk loop over all cohorts gives every cohort the results --
    state planes, step counts -- it gets when run alone, with one cohort
    leaving a chunk before the other (its own step bound) and, with the
    early exit tested every chunk, each leaving at its own latch."""
    monkeypatch.setattr(rt, "_EXIT_CHECK_CHUNKS", 1)
    cohorts = rt.plan_grid(SimConfig(**CFG), hash_small, LATS, [3, 20],
                           n_ops=60, device="cpu",
                           bucket_threads=bucket_threads)
    assert len(cohorts) == (2 if bucket_threads else 1)
    # unequal step bounds: the first cohort's ends a chunk before the last
    for i, c in enumerate(cohorts):
        c.steps = (1 if i == 0 and len(cohorts) > 1 else 2) * rt._RNG_CHUNK
    kw = dict(substeps=rt._RNG_CHUNK, use_kernel=False,
              early_exit=early_exit)
    grouped = rt._run_cohorts(cohorts, **kw)
    for c, out in zip(cohorts, grouped):
        _outs_equal(out, rt._run_cohorts([c], **kw)[0])
    runs = [o["steps_run"] for o in grouped]
    if early_exit:
        assert runs == [rt._RNG_CHUNK] * len(cohorts)   # latched at once
    else:
        assert runs == [c.steps for c in cohorts]
        if bucket_threads:
            assert runs[0] < runs[1]


def test_grid_of_more_cohorts_than_a_launch_takes(monkeypatch, hash_small):
    """Nine thread buckets are nine cohorts: the loop steps them in launches
    of at most MAX_COHORTS, and each cell's numbers stay its own."""
    monkeypatch.setattr(rt, "_EXIT_CHECK_CHUNKS", 1)
    cands = [1, 2, 3, 5, 9, 17, 33, 65, 129]
    cfg = SimConfig(P=4, seed=3)
    cohorts = rt.plan_grid(cfg, hash_small, [2 * US], cands, n_ops=20,
                           device="cpu")
    assert len(cohorts) > sk.MAX_COHORTS
    many = rt.sweep_grid(cfg, hash_small, [2 * US], cands, n_ops=20,
                         device="cpu")
    for j in (0, 4, 8):
        alone = rt.sweep_grid(cfg, hash_small, [2 * US], [cands[j]],
                              n_ops=20, device="cpu")
        assert alone.throughput[0, 0] == many.throughput[0, j]


def test_multi_cohort_grid_bit_equal_to_reference(monkeypatch, hash_small,
                                                  hash_small_ref):
    """A grid of three cohorts through the grouped loop, fed the reference's
    draws, is the reference's grid (run cohort by cohort there)."""
    monkeypatch.setattr(rt, "_EXIT_CHECK_CHUNKS", 1)
    lats, cands, n_ops = [1 * US, 5 * US], [3, 8, 12], 100
    ref = _reference_grid(monkeypatch, CFG, hash_small_ref, lats, cands,
                          n_ops=n_ops)
    got = rt.sweep_grid(SimConfig(**CFG), hash_small, lats, cands,
                        n_ops=n_ops, device="cpu",
                        draws=ReferenceDraws(CFG["seed"]))
    assert len(rt.plan_grid(SimConfig(**CFG), hash_small, lats, cands,
                            n_ops=n_ops, device="cpu")) == 3
    for fld in ("throughput", "time", "mem_stall_total", "mem_accesses"):
        assert np.array_equal(getattr(ref, fld), getattr(got, fld)), fld


@pytest.mark.parametrize("jitter", [0.25, 0.0])
def test_concatenated_draws_equal_per_cohort_blocks(hash_small, jitter):
    """One draw over the cohorts' stream ids side by side is, column block
    by column block, each cohort's own uniform block drawn alone (n_u 1
    and 0)."""
    cfg = SimConfig(**CFG, L_io_jitter=jitter)
    cohorts = rt.plan_grid(cfg, hash_small, LATS, [3, 8, 40], n_ops=60,
                           device="cpu")
    assert len(cohorts) == 3
    for ck in (0, 3):
        got = rt.cohort_uniforms(cohorts, ck)
        want = torch.cat([rt.cohort_uniforms([c], ck) for c in cohorts],
                         dim=2)
        assert got.shape == (rt._RNG_CHUNK, cohorts[0].n_u,
                             sum(c.G for c in cohorts))
        assert bits_equal(got.numpy(), want.numpy())
        assert bits_equal(rt.cohort_uniforms(cohorts[1:], ck).numpy(),
                          want[:, :, cohorts[0].G:].numpy())


@pytest.mark.parametrize("name", sorted(cases.FLAG_SETS))
def test_grouped_wrapper_on_cpu_is_plain_per_cohort(hash_small, name):
    """``fused_steps_group`` on CPU tensors: three cohorts (T 5 / 40 / 70),
    one leaving after 64 steps, each bit-equal to the plain version alone;
    it counts no kernel launch."""
    g = cases.make_group_case(hash_small, cases.FLAG_SETS[name], 29,
                              n_steps=128)
    steps = (128, 64, 128)
    before = sk.fused_steps.launches
    got = cases.run_group_fused(g, "cpu", steps, block=64)
    want = cases.run_group_plain(g, "cpu", steps)
    assert sk.fused_steps.launches == before
    for c, a, b in zip(g["cohorts"], want, got):
        ok, err, bad = cases.states_agree(a, b, False)
        assert ok, f"{name}: plane {bad} differs (max abs err {err})"


# -- the kernel's argument block -----------------------------------------------


def _c_fields(struct: str) -> list[str]:
    """Field names of ``struct <name> { ... };`` in ``sched_step.cu``, in
    declaration order (comments dropped, comma lists expanded)."""
    src = CSRC.read_text()
    body = re.search(rf"struct {struct} \{{(.*?)\n\}};", src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    names = []
    for decl in body.split(";"):
        decl = decl.strip()
        if not decl:
            continue
        head, *rest = decl.split(",")
        names.append(re.sub(r"\[.*\]", "", head.split()[-1]).lstrip("*"))
        names += [r.strip().lstrip("*") for r in rest]
    return names


def test_argument_block_mirrors_the_c_structs():
    assert [n for n, _ in sk._SchedCohort._fields_] == \
        _c_fields("SchedCohort")
    assert [n for n, _ in sk._SchedArgs._fields_] == _c_fields("SchedArgs")
    src = CSRC.read_text()
    assert f"#define SCHED_MAX_COHORTS {sk.MAX_COHORTS}\n" in src
    assert f"#define SCHED_N_PROF {len(sk.PROF_COLUMNS)}\n" in src
    assert len(sk.PROF_PHASES) == len(re.findall(r"clk\.stamp\(\d\)", src))


def _plan3(trace, **kw):
    cfg = SimConfig(**{**CFG, **kw})
    cohorts = rt.plan_grid(cfg, trace, LATS, [5, 40, 70], n_ops=60,
                           device="cpu")
    return cohorts, rt.cohort_uniforms(cohorts, 0)


def _args(cohorts, us, prof=None, parts=None):
    c0 = cohorts[0]
    if parts is None:
        parts = [(c.state, c.L_mem_g, c.nthr_g, c.warm_g) for c in cohorts]
    return sk.group_args(c0.substep.flags, parts, us, c0.kd, c0.se, c0.arr,
                         c0.n_trace, c0.n_ops, c0.dyn, prof)


@pytest.mark.parametrize("has_lat", [False, True])
def test_argument_block_layout(hash_small, has_lat):
    """G prefix sums, each cohort's NS and planes in the C struct's order,
    the shared tables, and absent planes as null pointers."""
    cfg = SimConfig(**CFG)
    cohorts = rt.plan_grid(cfg, hash_small, LATS, [5, 40, 70], n_ops=60,
                           device="cpu", collect_percentiles=has_lat)
    us = rt.cohort_uniforms(cohorts, 0)
    G = sum(c.G for c in cohorts)
    prof = torch.zeros(G, len(sk.PROF_COLUMNS), dtype=torch.int64)
    a = _args(cohorts, us, prof)
    assert (a.n_cohorts, a.n_blocks, a.K, a.n_u) == (3, G, rt._RNG_CHUNK, 1)
    assert (a.P, a.S, a.C, a.W, a.NCI) == \
        (12, 2, 1, 3 if has_lat else 2, 7 if has_lat else 6)
    assert [a.co[i].block0 for i in range(3)] == [0, 2, 4]
    assert [a.co[i].NS for i in range(3)] == [1, 2, 4]
    assert [a.co[i].T for i in range(3)] == [5, 40, 70]
    assert [a.co[i].G for i in range(3)] == [2, 2, 2]
    for i, c in enumerate(cohorts):
        planes = sk._split_state(c.state, c.substep.flags)
        named = dict(planes, L_mem_g=c.L_mem_g, nthr_g=c.nthr_g,
                     warm_g=c.warm_g)
        for f in sk._COHORT_PTR_FIELDS:
            want = named[f].data_ptr() if f in named else None
            assert getattr(a.co[i], f) == want, (i, f)
    for i in range(3, sk.MAX_COHORTS):
        assert a.co[i].cf is None and a.co[i].G == 0
    assert (a.u, a.kd, a.se, a.prof) == (
        us.data_ptr(), cohorts[0].kd.data_ptr(), cohorts[0].se.data_ptr(),
        prof.data_ptr())
    assert a.arr is None                       # closed loop
    assert a.has_rio == 1 and a.has_bio == 0 and a.has_lat == int(has_lat)
    assert a.n_ops == 60.0 and a.L_switch == 0.3 * US


def test_argument_block_refusals(hash_small):
    cohorts, us = _plan3(hash_small)
    parts = [(c.state, c.L_mem_g, c.nthr_g, c.warm_g) for c in cohorts]
    nine = (parts * 3)[:sk.MAX_COHORTS + 1]
    u9 = torch.zeros(rt._RNG_CHUNK, 1,
                     sum(p[0][2].shape[0] for p in nine),
                     dtype=torch.float64)
    with pytest.raises(ValueError, match="1 to 8 cohorts"):
        _args(cohorts, u9, parts=nine)
    with pytest.raises(ValueError, match="1 to 8 cohorts"):
        _args(cohorts, us[:, :, :0], parts=[])
    with pytest.raises(ValueError, match="u must be"):
        _args(cohorts, us[:, :, :-1].contiguous())
    with pytest.raises(ValueError, match="prof must be"):
        _args(cohorts, us, torch.zeros(6, 3, dtype=torch.int64))
    # a cohort over the kernel's limits: thread slots, shared memory
    wide = list(parts)
    st = list(wide[2][0])
    st[2] = st[3] = torch.zeros(2, 300, dtype=torch.float64)
    wide[2] = (tuple(st),) + wide[2][1:]
    with pytest.raises(ValueError, match="thread slots"):
        _args(cohorts, us, parts=wide)
    big = SimConfig(**{**CFG, "n_cores": 32, "P": 256})
    fat = rt.plan_grid(big, hash_small, LATS[:1], [8], n_ops=60,
                       device="cpu")
    with pytest.raises(ValueError, match="shared memory"):
        _args(fat, rt.cohort_uniforms(fat, 0))
    # every cohort of a launch shares P
    other, _ = _plan3(hash_small, P=4)
    mixed = parts[:2] + [(other[2].state, other[2].L_mem_g,
                          other[2].nthr_g, other[2].warm_g)]
    with pytest.raises(ValueError, match="shares P"):
        _args(cohorts, us, parts=mixed)


def test_profiling_instance_refused_on_the_cpu(hash_small):
    cohorts, us = _plan3(hash_small)
    c0 = cohorts[0]
    parts = [(c.state, c.L_mem_g, c.nthr_g, c.warm_g) for c in cohorts]
    prof = torch.zeros(us.shape[2], len(sk.PROF_COLUMNS), dtype=torch.int64)
    with pytest.raises(ValueError, match="profiling instance"):
        sk.fused_steps_group(c0.substep, parts, us[:4], c0.kd, c0.se,
                             c0.arr, c0.n_trace, c0.n_ops, c0.dyn, prof=prof)


def test_slot_count():
    assert [sk.slot_count(T) for T in (1, 32, 33, 64, 65, 128, 129, 256)] \
        == [1, 1, 2, 2, 4, 4, 8, 8]
