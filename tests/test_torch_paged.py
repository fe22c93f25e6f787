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
    # PAGED_CASES row 5 (page 64, D 128, float32, 2 buffers): a 128 KiB ring
    assert pk.smem_bytes(8, 128, 64, 2, 4) - 2 * 2 * 64 * 128 * 4 == \
        4 * (2 * 8 * 128 + 8 * 64 + 3 * 8)
    assert 2 * 2 * 64 * 128 * 4 == 128 * 1024
    for case in cases.PAGED_CASES:
        B, Hq, Hkv, D, page, ppseq, _, dt = case
        for nb in (2, 3, 4):
            n_buf = max(2, min(nb, ppseq))
            smem = pk.smem_bytes(Hq // Hkv, D, page, n_buf,
                                 torch.tensor([], dtype=getattr(torch, dt))
                                 .element_size())
            assert smem <= pk.MAX_SMEM_BYTES, (case, nb)


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
