"""wkv6: the port's plain version, and ``ops.wkv6`` on CPU tensors, against
the reference's Pallas kernel run as the reference's own tests run it on the
CPU (interpret mode, through ``repro.kernels.ops``) and against the
reference's plain version; the ``S % chunk`` refusal of both packages; and the
refusals of the CUDA wrapper, which are decided before anything touches the
card.

Inputs are drawn by numpy from a seed and scaled as the reference's test
scales them (``tests/_torch_kernel_cases.py``); tolerance: the reference's
``_tol`` (3e-2 bfloat16, 5e-5 float32), absolute after dividing both sides by
``max|reference| + 1e-6``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels.ref import wkv6_ref as ref_plain
from repro_torch.kernels import ops
from repro_torch.kernels import wkv6 as wk
from repro_torch.kernels.ref import wkv6_ref

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
