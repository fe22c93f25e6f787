"""Paged decode attention: the port's plain version against the reference's
Pallas kernel, run as the reference's own tests run it on the CPU (interpret
mode, through ``repro.kernels.ops``), and the refusals of the CUDA wrapper,
which are decided before anything touches the card.

Inputs are drawn by numpy from a seed (``tests/_torch_kernel_cases.py``,
shared with ``chip_smoke.py``); tolerance: the reference's ``_tol``, 3e-2
absolute in bfloat16 and 5e-5 in float32.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels.ref import paged_decode_attention_ref as ref_plain
from repro_torch.kernels import ops
from repro_torch.kernels import paged_kv_gather as pk
from repro_torch.kernels.ref import paged_decode_attention_ref

import _torch_kernel_cases as cases

JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}

CASES = {f"paged-{i}": c for i, c in enumerate(cases.PAGED_CASES)}
CASES["edge-len1-full"] = cases.PAGED_EDGE
CASES["serve-shape"] = cases.PAGED_SERVE


def _jax_inputs(c):
    dt = JNP[c["dtype"]]
    return (jnp.asarray(c["q"], dt), jnp.asarray(c["k_pages"], dt),
            jnp.asarray(c["v_pages"], dt), jnp.asarray(c["block_tables"]),
            jnp.asarray(c["lengths"]))


def f32(x):
    if torch.is_tensor(x):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_version_matches_reference_kernel(name):
    c = cases.make_paged_case(CASES[name], seed=1)
    tol = cases.PAGED_TOL[c["dtype"]]
    want = ref_ops.paged_decode_attention(*_jax_inputs(c),
                                          n_buffers=c["n_buffers"])
    got = ops.paged_decode_attention(*cases.paged_tensors(c, "cpu"),
                                     n_buffers=c["n_buffers"])
    assert got.dtype == getattr(torch, c["dtype"])
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(f32(got), f32(want), atol=tol, rtol=0)
    # and against the reference's own plain version
    np.testing.assert_allclose(f32(got), f32(ref_plain(*_jax_inputs(c))),
                               atol=tol, rtol=0)


def test_cpu_tensors_run_the_plain_version():
    c = cases.make_paged_case(cases.PAGED_CASES[0], seed=2)
    args = cases.paged_tensors(c, "cpu")
    before = pk.paged_decode_attention.launches
    assert torch.equal(ops.paged_decode_attention(*args),
                       paged_decode_attention_ref(*args))
    assert pk.paged_decode_attention.launches == before


def test_shared_memory_of_the_reference_cases():
    # PAGED_CASES row 5 (page 64, D 128, float32, 2 buffers): scalar_f32's
    # 128 KiB ring of two pages, then q rows, accumulators, a page of scores
    # and three per-row scalars
    assert pk.smem_bytes("scalar_f32", 8, 128, 64, 2) \
        - 2 * 2 * 64 * 128 * 4 == 4 * (2 * 8 * 128 + 8 * 64 + 3 * 8)
    assert 2 * 2 * 64 * 128 * 4 == 128 * 1024
    # ... in bfloat16 (mma_bf16): 2 pages of 64 ahead are 2 rounds, so a ring
    # of 3 rounds of 64 K and V rows of 256 bytes, 96 KiB
    assert pk.ring_rounds(2, 64) == 3
    assert pk.smem_bytes("mma_bf16", 8, 128, 64, 2) == 3 * 2 * 64 * 256
    # the serving shape (page 16): 2 pages fit in one round ahead
    assert pk.ring_rounds(2, 16) == 2 and pk.ring_rounds(8, 16) == 3
    # the merges' scratch reuses the ring; at D 32 and rep 16 with 256
    # splits it is the larger of the two
    merge = 4 * (3 * 4 * 16 + 4 * 16 * 32 + 2 * 16 + 257 * 16)
    assert pk.smem_bytes("mma_bf16", 16, 32, 8, 2, 256) == merge > \
        2 * pk.ring_rounds(2, 8) * 64 * 32 * 2
    for case in cases.PAGED_CASES:
        B, Hq, Hkv, D, page, ppseq, _, dt = case
        for nb in (2, 3, 4):
            n_buf = max(2, min(nb, ppseq))
            for inst in pk.INSTANCES:
                n, _ = pk.split_plan(B, Hkv, ppseq, page, inst)
                smem = pk.smem_bytes(inst, Hq // Hkv, D, page, n_buf, n)
                assert smem <= pk.MAX_SMEM_BYTES, (case, nb, inst)


def _shape(case):
    """(B, Hq, Hkv, D, page, ppseq) of any paged case."""
    if isinstance(case, tuple):
        return case[:6]
    if "S" in case:                               # PAGED_BENCH
        return (case["B"], case["Hq"], case["Hkv"], case["D"], case["page"],
                case["S"] // case["page"])
    return tuple(case[k] for k in ("B", "Hq", "Hkv", "D", "page", "ppseq"))


PLAN_CASES = {**CASES, "long-32k": cases.PAGED_LONG,
              "bench": cases.PAGED_BENCH,
              **{f"split-{k}": v for k, v in cases.PAGED_SPLIT_CASES.items()}}


@pytest.mark.parametrize("instance", sorted(pk.INSTANCES))
@pytest.mark.parametrize("name", sorted(PLAN_CASES))
def test_split_plan_covers_every_page_once(name, instance):
    """Every page < ppseq lies in exactly one split, for the plan's own
    count and for forced ones (1, 2, an odd 3, more splits than pages), and
    the shared memory of each instance and the merge's workspace fit."""
    B, Hq, Hkv, D, page, ppseq = _shape(PLAN_CASES[name])
    rep = Hq // Hkv
    for forced in (None, 1, 2, 3, min(ppseq + 3, pk.MAX_SPLITS)):
        n, pps = pk.split_plan(B, Hkv, ppseq, page, instance,
                               n_splits=forced)
        if forced is not None:
            assert n == forced
        owner = np.full(ppseq, -1)
        for s in range(n):
            span = owner[s * pps:(s + 1) * pps]
            assert (span == -1).all(), (name, forced, s)
            span[:] = s
        assert (owner >= 0).all(), (name, forced)
        for nb in (2, 3, 4):
            smem = pk.smem_bytes(instance, rep, D, page,
                                 max(2, min(nb, ppseq)), n)
            if instance == "mma_bf16" or nb == 2:
                assert smem <= pk.MAX_SMEM_BYTES, (name, forced, nb)
        ws = pk.workspace_bytes(B, Hkv, rep, D, n)
        assert ws == (0 if n == 1 else
                      4 * B * Hkv * n * rep * (D + 2) + 4 * B * Hkv)


def test_split_plan_at_the_named_shapes():
    """One split where the (b, h) pairs fill the card (``PAGED_BENCH``: 1024
    pairs), many where they do not: 16 of 4 pages (one 64-row round) at the
    serving shape, 32 of 64 pages at 32k; about 4 blocks an SM."""
    for inst in pk.INSTANCES:
        B, Hq, Hkv, D, page, ppseq = _shape(cases.PAGED_BENCH)
        assert pk.split_plan(B, Hkv, ppseq, page, inst) == (1, ppseq)
    B, Hq, Hkv, D, page, ppseq = _shape(cases.PAGED_LONG)
    assert pk.split_plan(B, Hkv, ppseq, page, "mma_bf16") == (32, 64)
    B, Hq, Hkv, D, page, ppseq = _shape(cases.PAGED_SERVE)
    assert pk.split_plan(B, Hkv, ppseq, page, "mma_bf16") == (16, 4)
    assert pk.split_plan(B, Hkv, ppseq, page, "scalar_f32") == (16, 4)
    # a card with fewer SMs gets fewer splits; the lengths play no part
    assert pk.split_plan(8, 2, 2048, 16, "mma_bf16", n_sm=66)[0] < 32
    with pytest.raises(ValueError, match="n_splits"):
        pk.split_plan(8, 2, 2048, 16, "mma_bf16", n_splits=0)
    with pytest.raises(ValueError, match="n_splits"):
        pk.split_plan(8, 2, 2048, 16, "mma_bf16", n_splits=pk.MAX_SPLITS + 1)


def test_launch_plan_picks_the_instance_and_the_split():
    c = cases.make_paged_case(cases.PAGED_SERVE, seed=1)
    for dt, inst, ring in (("bfloat16", "mma_bf16", 2),
                           ("float32", "scalar_f32", 2)):
        args = cases.paged_tensors(c, "cpu", dt)
        plan = pk.launch_plan(*args)
        assert plan["instance"] == inst == pk.instance_for(args[0].dtype)
        assert (plan["n_splits"], plan["pps"], plan["ring"]) == (16, 4, ring)
        assert plan["grid"] == (16, 2, 8)
        assert plan["workspace_bytes"] == 4 * 16 * 16 * 8 * 130 + 4 * 16
        forced = pk.launch_plan(*args, n_splits=5)
        assert (forced["n_splits"], forced["pps"]) == (5, 13)
        single = pk.launch_plan(*args, n_splits=1)
        assert single["workspace_bytes"] == 0
    assert pk.launch_plan(*cases.paged_tensors(c, "cpu"), n_buffers=8)[
        "ring"] == 3


@pytest.mark.parametrize("what,shape,match", [
    ("rep 24 in one mma tile", dict(Hq=48, Hkv=2), "rep"),
    ("head_dim 96", dict(D=96), "head_dim 96"),
])
def test_tensor_core_instance_limits(what, shape, match):
    """``mma_bf16`` takes rep <= 16 and D 32 / 64 / 128; beyond, the plan
    raises (``ROADMAP.md``, Limits).  float32 takes both on ``scalar_f32``."""
    base = dict(B=2, Hq=8, Hkv=2, D=64, page=16, ppseq=4, n_pages=16,
                dtype="bfloat16", lengths=(40, 9))
    c = cases.make_paged_case({**base, **shape}, seed=4)
    with pytest.raises(ValueError, match=match):
        pk.launch_plan(*cases.paged_tensors(c, "cpu"))
    plan = pk.launch_plan(*cases.paged_tensors(c, "cpu", "float32"))
    assert plan["instance"] == "scalar_f32"


@pytest.mark.parametrize("i", range(len(cases.PAGED_CASES)))
def test_out_of_store_page_ids_read_as_jnp_reads_them(i):
    """A table holding ids ``P + 2``, ``-1`` and ``-(P + 3)`` inside and past
    each sequence's pages: the port's plain version equals the reference's
    plain version (a jnp gather: wrap a negative id once, then clamp)."""
    c = cases.with_bad_page_ids(cases.make_paged_case(cases.PAGED_CASES[i],
                                                      seed=6))
    P = c["k_pages"].shape[0]
    assert (c["block_tables"] >= P).any() and (c["block_tables"] < 0).any()
    tol = cases.PAGED_TOL[c["dtype"]]
    want = ref_plain(*_jax_inputs(c))
    got = paged_decode_attention_ref(*cases.paged_tensors(c, "cpu"))
    np.testing.assert_allclose(f32(got), f32(want), atol=tol, rtol=0)
    # the rule itself, on the ids alone
    ids = jnp.asarray([P + 2, -1, -(P + 3), -P, P])
    assert np.asarray(jnp.arange(P)[ids]).tolist() == [P - 1, P - 1, 0, 0,
                                                        P - 1]


@pytest.mark.parametrize("name", sorted(cases.PAGED_SPLIT_CASES))
def test_plain_version_on_the_split_cases(name):
    """The split cases' inputs (lengths 0 and 1, mid-page ends, rep 12 and
    16, D 32) through the port's and the reference's plain versions in
    float32; a length-0 sequence gives zeros in both."""
    c = cases.make_paged_case(cases.PAGED_SPLIT_CASES[name], seed=1)
    c["dtype"] = "float32"
    want = ref_plain(*_jax_inputs(c))
    got = paged_decode_attention_ref(*cases.paged_tensors(c, "cpu"))
    np.testing.assert_allclose(f32(got), f32(want),
                               atol=cases.PAGED_TOL["float32"], rtol=0)
    for b, n in enumerate(c["lengths"]):
        if n == 0:
            assert not f32(got)[b].any()


def _bad(**over):
    c = cases.make_paged_case(cases.PAGED_CASES[0], seed=3)
    q, k, v, bt, ln = cases.paged_tensors(c, "cpu")
    args = dict(q=q, k_pages=k, v_pages=v, block_tables=bt, lengths=ln)
    args.update(over)
    return args


@pytest.mark.parametrize("what,over,match", [
    ("float16", lambda a: dict(q=a["q"].half(), k_pages=a["k_pages"].half(),
                               v_pages=a["v_pages"].half()), "dtype"),
    ("mixed dtypes", lambda a: dict(k_pages=a["k_pages"].double()),
     "share one dtype"),
    ("non-contiguous store", lambda a: dict(
        k_pages=a["k_pages"].transpose(1, 2).contiguous().transpose(1, 2)),
     "contiguous"),
    ("int64 tables", lambda a: dict(block_tables=a["block_tables"].long()),
     "int32"),
    ("row not 16 B", lambda a: dict(q=a["q"][..., :62].contiguous(),
                                    k_pages=a["k_pages"][..., :62]
                                    .contiguous(),
                                    v_pages=a["v_pages"][..., :62]
                                    .contiguous()), "16-byte"),
    ("heads", lambda a: dict(q=a["q"][:, :3].contiguous()), "multiple"),
    ("too much shared memory", lambda a: dict(
        k_pages=torch.zeros(4, 256, 2, 64), v_pages=torch.zeros(4, 256, 2, 64)),
     "shared memory"),
    ("cpu", lambda a: {}, "CPU"),
])
def test_cuda_wrapper_refuses(what, over, match):
    """Every input the kernel does not take raises ``ValueError`` in the
    wrapper -- and so does a CPU tensor: it never falls back."""
    base = _bad()
    args = _bad(**over(base))
    with pytest.raises(ValueError, match=match):
        pk.paged_decode_attention(**args)
