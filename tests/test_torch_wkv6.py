"""wkv6: the port's plain version, and ``ops.wkv6`` on CPU tensors, against
the reference's Pallas kernel run as the reference's own tests run it on the
CPU (interpret mode, through ``repro.kernels.ops``) and against the
reference's plain version; the chunked twin of the tensor-core instance
(``wkv6_chunked_ref``) against the Pallas kernel, the reference model's
``wkv_chunked`` and the plain version, also under strong decays; the
``S % chunk`` refusal of both packages; and the launch plan and refusals of
the CUDA wrapper, which are decided before anything touches the card.

Inputs are drawn by numpy from a seed and scaled as the reference's test
scales them (``tests/_torch_kernel_cases.py``); tolerance: the reference's
``_tol`` (3e-2 bfloat16, 5e-5 float32), absolute after dividing both sides by
``max|reference| + 1e-6``.  The twin is held in float32 on the case's
inputs (bf16-valued r, k, v): 5e-5, the float32 limit, since it and the
references differ only in the order of float32 sums and in forming the
decays as products of ``exp(log_w)`` rather than ``exp`` of sums.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels.ref import wkv6_ref as ref_plain
from repro.models.rwkv6 import wkv_chunked
from repro_torch.kernels import ops
from repro_torch.kernels import wkv6 as wk
from repro_torch.kernels.ref import wkv6_chunked_ref, wkv6_ref

import _torch_kernel_cases as cases

JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
IDS = [f"wkv-{i}" for i in range(len(cases.WKV_CASES))]


def _jax_inputs(c):
    dt = JNP[c["dtype"]]
    return (jnp.asarray(c["r"], dt), jnp.asarray(c["k"], dt),
            jnp.asarray(c["v"], dt), jnp.asarray(c["log_w"]),
            jnp.asarray(c["u"]))


def _t(x):
    return torch.from_numpy(np.array(jnp.asarray(x, jnp.float32)))


TWIN_CASES = cases.WKV_CASES + cases.WKV_TC_CASES
TWIN_IDS = IDS + [f"tc-{i}" for i in range(len(cases.WKV_TC_CASES))]
F32_TOL = cases.tol("float32")
#: ... and of one row relative to the row: the decay of an old term is a
#: product of up to 4096 float32 factors on either side, formed in another
#: order (per step there, per quarter here), each rounding by up to 2^-24:
#: 4096 x 2^-24 = 2.4e-4 on each side
TWIN_ROW_TOL = 5e-4


def _f32(c):
    """The case's tensors as the kernel takes them (r, k, v in its dtype,
    log_w in its own), then float32: the twin and the references see the
    same values."""
    return tuple(t.float() for t in cases.wkv_tensors(c, "cpu"))


def _np(x):
    return jnp.asarray(x.numpy())


@pytest.mark.parametrize("case", TWIN_CASES, ids=TWIN_IDS)
def test_chunked_twin_matches_reference_kernel(case):
    """The tensor-core instance's arithmetic against the reference's Pallas
    kernel in interpret mode, with the caller's chunk of the case."""
    c = cases.make_wkv_case(case, seed=0)
    args = _f32(c)
    want = ref_ops.wkv6(*map(_np, args), chunk=c["chunk"])
    got = wkv6_chunked_ref(*args)
    assert got.dtype == torch.float32
    assert cases.wkv_err(got, _t(want)) <= F32_TOL


@pytest.mark.parametrize("case", TWIN_CASES, ids=TWIN_IDS)
def test_chunked_twin_matches_reference_model(case):
    """... against the reference model's chunk-parallel ``wkv_chunked``
    (chunks of the caller's size there, of 32 with quarters of 8 here)."""
    c = cases.make_wkv_case(case, seed=1)
    args = _f32(c)
    want, _ = wkv_chunked(*map(_np, args), chunk=c["chunk"])
    assert cases.wkv_err(wkv6_chunked_ref(*args), _t(want)) <= F32_TOL


@pytest.mark.parametrize("case", TWIN_CASES, ids=TWIN_IDS)
def test_chunked_twin_matches_plain_version(case):
    c = cases.make_wkv_case(case, seed=2)
    args = _f32(c)
    got = wkv6_chunked_ref(*args)
    want = wkv6_ref(*args)
    assert cases.wkv_err(got, want) <= F32_TOL
    assert cases.row_rel_err(got, want) <= TWIN_ROW_TOL


@pytest.mark.parametrize("decay", cases.WKV_DECAYS)
@pytest.mark.parametrize("w_dtype", ["float32", "bfloat16"])
def test_chunked_twin_under_strong_decays(decay, w_dtype):
    """w = 5e-6 on every step (products of eight underflow), and channels
    alternating between w ~ 1 and w = 6e-6: no inf or NaN, and the twin
    still agrees with the sequential recurrence over 4096 steps."""
    c = cases.make_wkv_case((1, 4096, 2, 64, 64, "bfloat16", w_dtype),
                            seed=3, decay=decay)
    args = _f32(c)
    got = wkv6_chunked_ref(*args)
    assert bool(torch.isfinite(got).all())
    want = wkv6_ref(*args)
    assert cases.wkv_err(got, want) <= F32_TOL
    assert cases.row_rel_err(got, want) <= TWIN_ROW_TOL


@pytest.mark.parametrize("case", cases.WKV_CASES, ids=IDS)
def test_ops_matches_reference_kernel(case):
    c = cases.make_wkv_case(case, seed=0)
    want = ref_ops.wkv6(*_jax_inputs(c), chunk=c["chunk"])
    got = ops.wkv6(*cases.wkv_tensors(c, "cpu"), chunk=c["chunk"])
    assert got.dtype == getattr(torch, c["dtype"])
    assert tuple(got.shape) == tuple(want.shape)
    assert cases.wkv_err(got, _t(want)) <= cases.tol(c["dtype"])


@pytest.mark.parametrize("case", cases.WKV_CASES, ids=IDS)
def test_plain_version_matches_reference_plain_version(case):
    c = cases.make_wkv_case(case, seed=0)
    want = ref_plain(*_jax_inputs(c))
    got = wkv6_ref(*cases.wkv_tensors(c, "cpu"))
    assert got.dtype == getattr(torch, c["dtype"])
    assert cases.wkv_err(got, _t(want)) <= cases.tol(c["dtype"])


def test_s_not_a_chunk_multiple_is_refused_by_both_packages():
    c = cases.make_wkv_case((1, 96, 1, 32, 64, "float32"), seed=1)
    with pytest.raises(AssertionError, match="chunk multiple"):
        ref_ops.wkv6(*_jax_inputs(c), chunk=64)
    with pytest.raises(ValueError, match="chunk multiple"):
        ops.wkv6(*cases.wkv_tensors(c, "cpu"), chunk=64)
    with pytest.raises(ValueError, match="chunk multiple"):
        wk.wkv6(*cases.wkv_tensors(c, "cpu"), chunk=64)


def test_chunk_is_cut_to_the_sequence():
    """``chunk = min(chunk, S)``: a chunk longer than S is taken."""
    assert wk.check_chunk(96, 128) == 96
    assert wk.check_chunk(96, 32) == 32
    c = cases.make_wkv_case((1, 48, 2, 32, 64, "float32"), seed=2)
    args = cases.wkv_tensors(c, "cpu")
    assert torch.equal(ops.wkv6(*args, chunk=128), wkv6_ref(*args))


def test_cpu_tensors_run_the_plain_version():
    c = cases.make_wkv_case(cases.WKV_CASES[0], seed=3)
    args = cases.wkv_tensors(c, "cpu")
    before = wk.wkv6.launches
    assert torch.equal(ops.wkv6(*args, chunk=16), wkv6_ref(*args))
    assert wk.wkv6.launches == before


def test_shared_memory_of_the_staged_chunk():
    # 64 steps of r, k, exp(log_w), v and u at D 64: 65 792 bytes
    assert wk.smem_bytes(64, 64) == 4 * (4 * 64 * 64 + 64) == 65_792
    assert 3 * wk.smem_bytes(wk.MAX_STAGED_STEPS, wk.MAX_D) \
        <= wk.MAX_SMEM_BYTES


@pytest.mark.parametrize("D,w_bytes,want", [(64, 4, 76_304), (64, 2, 68_112),
                                            (32, 4, 42_768),
                                            (32, 2, 38_672)])
def test_shared_memory_of_the_tensor_core_instance(D, w_bytes, want):
    """``TcLayout`` of ``csrc/wkv6.cu``: at D 64 with float32 log_w two
    stages of 20 480 bytes (three 4 096-byte boxes and 8 192 of log_w), four
    32-row operand tiles of 4 608, four 16-row ones of 2 304, the score tile
    pair (2 x 2 560), 1 536 of decay, u and the quarters' log decay, 16 of
    mbarriers and 1 024 of alignment -- and three blocks fit one SM (228 KB less 1 KB a block), so
    the bench's 320 (b, h) are in flight at once on 132 SMs."""
    got = wk.tc_smem_bytes(D, w_bytes)
    assert got == want
    assert 3 * (got + 1024) <= 233_472
    assert 3 * 132 >= 8 * 40


def test_instances_are_picked_by_dtype():
    c = cases.make_wkv_case(cases.WKV_TC_CASES[4], seed=5)
    r, k, v, lw, u = cases.wkv_tensors(c, "cpu")
    assert wk.instance_for(torch.bfloat16) == "chunk_tc_bf16"
    assert wk.instance_for(torch.float32) == "scalar_f32"
    assert set(wk.wkv6.launches_by_instance) == set(wk.INSTANCES)
    with pytest.raises(ValueError, match="CPU"):
        wk.launch_plan(r, k, v, lw, u, chunk=32)


@pytest.mark.parametrize("case", cases.WKV_TC_CASES,
                         ids=[f"tc-{i}" for i in
                              range(len(cases.WKV_TC_CASES))])
def test_ops_runs_tensor_core_cases_on_the_cpu(case):
    """``ops.wkv6`` on CPU tensors of every tensor-core case (bf16 r, k, v,
    log_w of either type) runs the plain version and launches nothing."""
    c = cases.make_wkv_case(case, seed=6)
    args = cases.wkv_tensors(c, "cpu")
    before = dict(wk.wkv6.launches_by_instance)
    got = ops.wkv6(*args, chunk=c["chunk"])
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, wkv6_ref(*args))
    assert wk.wkv6.launches_by_instance == before


def _args(**over):
    c = cases.make_wkv_case(cases.WKV_CASES[0], seed=4)
    r, k, v, lw, u = cases.wkv_tensors(c, "cpu")
    args = dict(r=r, k=k, v=v, log_w=lw, u=u)
    args.update(over)
    return args


def _wide(a, D):
    B, S, H, _ = a["r"].shape
    z = torch.zeros(B, S, H, D)
    return dict(r=z, k=z, v=z, log_w=z, u=torch.zeros(H, D))


@pytest.mark.parametrize("what,over,match", [
    ("float16", lambda a: dict(r=a["r"].half(), k=a["k"].half(),
                               v=a["v"].half()), "dtype"),
    ("mixed dtypes", lambda a: dict(k=a["k"].double()), "share one dtype"),
    ("log_w float16", lambda a: dict(log_w=a["log_w"].half()), "log_w"),
    ("head_dim 80", lambda a: _wide(a, 80), "head_dim"),
    ("head_dim 30", lambda a: _wide(a, 30), "head_dim"),
    ("bf16 head_dim 48", lambda a: {k: t.bfloat16() if k in "rkv" else t
                                    for k, t in _wide(a, 48).items()},
     "head_dim 48 not taken by chunk_tc_bf16"),
    ("u shape", lambda a: dict(u=a["u"][:1]), "u "),
    ("k shape", lambda a: dict(k=a["k"][:, :32]), "does not match"),
    ("cpu", lambda a: {}, "CPU"),
])
def test_cuda_wrapper_refuses(what, over, match):
    """Every input the kernel does not take raises ``ValueError`` in the
    wrapper -- and so does a CPU tensor: it never falls back."""
    args = _args(**over(_args()))
    with pytest.raises(ValueError, match=match):
        wk.wkv6(**args, chunk=16)
