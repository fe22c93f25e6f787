"""Flash attention: the port's plain version, and ``ops.flash_attention`` on
CPU tensors, against the reference's Pallas kernel run as the reference's own
tests run it on the CPU (interpret mode, through ``repro.kernels.ops``) and
against the reference's plain version; the port's blockwise twin
(``models.layers.attention``) against ``ops.flash_attention``; and the
refusals of the CUDA wrapper, which are decided before anything touches the
card.

Inputs are drawn by numpy from a seed (``tests/_torch_kernel_cases.py``,
shared with ``chip_smoke.py``); tolerance: the reference's ``_tol``, 3e-2
absolute in bfloat16 and 5e-5 in float32.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels.ref import flash_attention_ref as ref_plain
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels.ref import flash_attention_ref
from repro_torch.models import layers

import _torch_kernel_cases as cases

JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
IDS = [f"flash-{i}" for i in range(len(cases.FLASH_CASES))]
TC_IDS = ["tc-B{}-S{}-H{}/{}-D{}-{}{}".format(
    B, S, Hq, Hkv, D, "causal" if causal else "full",
    f"-w{w}" if w else "")
    for B, S, Hq, Hkv, D, causal, w, *_ in cases.FLASH_TC_CASES]


def f32(x):
    if torch.is_tensor(x):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _jax_inputs(c):
    """Sequence-major jnp arrays of a case, in its dtype."""
    return tuple(jnp.asarray(c[n], JNP[c["dtype"]]) for n in ("q", "k", "v"))


@pytest.mark.parametrize("case", cases.FLASH_CASES, ids=IDS)
def test_ops_matches_reference_kernel(case):
    c = cases.make_flash_case(case, seed=0)
    q, k, v = (x.transpose(0, 2, 1, 3) for x in _jax_inputs(c))
    want = ref_ops.flash_attention(
        q, k, v, causal=c["causal"], sliding_window=c["window"],
        block_q=c["block_q"], block_k=c["block_k"])
    got = ops.flash_attention(
        *cases.flash_tensors(c, "cpu"), causal=c["causal"],
        sliding_window=c["window"], block_q=c["block_q"],
        block_k=c["block_k"])
    assert got.dtype == getattr(torch, c["dtype"])
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(f32(got), f32(want), atol=cases.tol(c["dtype"]),
                               rtol=0)


@pytest.mark.parametrize("case", cases.FLASH_TC_CASES, ids=TC_IDS)
def test_ops_matches_reference_kernel_on_tensor_core_cases(case):
    """The cases that cover every layout of the CUDA kernel's tensor-core
    instance, through the plain path here: 3e-2 absolute and
    ``FLASH_ROW_TOL`` relative to each query row."""
    c = cases.make_flash_case(case, seed=0)
    q, k, v = (x.transpose(0, 2, 1, 3) for x in _jax_inputs(c))
    want = ref_ops.flash_attention(
        q, k, v, causal=c["causal"], sliding_window=c["window"],
        block_q=c["block_q"], block_k=c["block_k"])
    got = ops.flash_attention(
        *cases.flash_tensors(c, "cpu"), causal=c["causal"],
        sliding_window=c["window"], block_q=c["block_q"],
        block_k=c["block_k"])
    assert got.dtype == torch.bfloat16
    assert tuple(got.shape) == tuple(want.shape)
    want = torch.from_numpy(np.array(f32(want)))
    np.testing.assert_allclose(f32(got), want.numpy(), atol=cases.tol(
        "bfloat16"), rtol=0)
    assert cases.row_rel_err(got, want) <= cases.FLASH_ROW_TOL


@pytest.mark.parametrize("case", cases.FLASH_CASES, ids=IDS)
def test_plain_version_matches_reference_plain_version(case):
    c = cases.make_flash_case(case, seed=0)
    want = ref_plain(*_jax_inputs(c), c["causal"], c["window"])
    got = flash_attention_ref(*cases.flash_tensors(c, "cpu", head_major=False),
                              c["causal"], c["window"])
    assert got.dtype == getattr(torch, c["dtype"])
    np.testing.assert_allclose(f32(got), f32(want), atol=cases.tol(c["dtype"]),
                               rtol=0)


@pytest.mark.parametrize("window", [None, 100])
def test_blockwise_twin_agrees(window):
    """The port's model-stack blockwise attention and the kernel's entry
    point are the same algorithm (tests/test_kernels.py:120): float32,
    S 256 in blocks of 128, 5e-5."""
    c = cases.make_flash_case((2, 256, 4, 2, 64, True, window, "float32",
                               128, 128), seed=5)
    q, k, v = cases.flash_tensors(c, "cpu", head_major=False)
    a = layers.attention(q, k, v, causal=True, sliding_window=window,
                         block_kv=128)
    b = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=True,
                            sliding_window=window, block_q=128,
                            block_k=128).transpose(1, 2)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=5e-5, rtol=0)


def test_cpu_tensors_run_the_plain_version():
    c = cases.make_flash_case(cases.FLASH_CASES[0], seed=2)
    q, k, v = cases.flash_tensors(c, "cpu")
    before = fa.flash_attention.launches
    got = ops.flash_attention(q, k, v, causal=True)
    want = flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), True).transpose(1, 2)
    assert torch.equal(got, want)
    assert fa.flash_attention.launches == before


def test_window_zero_means_no_window():
    """As in the reference's kernel (``sliding_window or 0``)."""
    c = cases.make_flash_case((1, 128, 2, 1, 32, True, None, "float32",
                               64, 64), seed=3)
    args = cases.flash_tensors(c, "cpu")
    assert torch.equal(ops.flash_attention(*args, sliding_window=0),
                       ops.flash_attention(*args, sliding_window=None))


def test_shared_memory_of_every_head_dim():
    # D 128: q and K/V tiles 64 x 132 floats, scores 64 x 68, 3 x 64 scalars
    assert fa.smem_bytes(128) == 4 * (2 * 64 * 132 + 64 * 68 + 3 * 64) \
        == 85_760
    assert fa.smem_bytes(128, "scalar_f32") == fa.smem_bytes(128)
    for D in fa.HEAD_DIMS:
        # two blocks an SM fit in its 228 KiB
        assert 2 * fa.smem_bytes(D) <= fa.MAX_SMEM_BYTES
        # wgmma_bf16: alignment slack, the bf16 Q tile (128 rows), three
        # stages of a K and a V tile (128 rows each), 13 barriers
        tc = fa.smem_bytes(D, "wgmma_bf16")
        assert tc == 1024 + 2 * D * (128 + 2 * 3 * 128) + 8 * 13
        assert tc <= fa.MAX_SMEM_BYTES
    assert fa.smem_bytes(128, "wgmma_bf16") == 230_504
    with pytest.raises(ValueError, match="instance"):
        fa.smem_bytes(64, "tf32")


@pytest.mark.parametrize("dtype,instance,threads,rows,grid", [
    ("bfloat16", "wgmma_bf16", 384, 128, (3, 16)),
    ("float32", "scalar_f32", 256, 64, (16, 5)),
])
def test_launch_plan_picks_the_instance_by_dtype(dtype, instance, threads,
                                                 rows, grid):
    c = cases.make_flash_case((2, 300, 8, 2, 64, True, None, dtype, 128, 128),
                              seed=6)
    plan = fa.launch_plan(*cases.flash_tensors(c, "cpu"))
    assert plan["instance"] == fa.instance_for(getattr(torch, dtype)) \
        == instance
    assert (plan["threads"], plan["block_q"]) == (threads, rows)
    assert plan["grid"] == grid
    assert plan["smem"] == fa.smem_bytes(64, instance)


def _args(**over):
    c = cases.make_flash_case(cases.FLASH_CASES[0], seed=4)
    q, k, v = cases.flash_tensors(c, "cpu")
    args = dict(q=q, k=k, v=v)
    args.update(over)
    return args


@pytest.mark.parametrize("what,over,match", [
    ("float16", lambda a: {n: t.half() for n, t in a.items()}, "dtype"),
    ("mixed dtypes", lambda a: dict(k=a["k"].double()), "share one dtype"),
    ("heads", lambda a: dict(q=a["q"][:, :3].contiguous()), "multiple"),
    ("head_dim 48", lambda a: {n: t[..., :48].contiguous()
                               for n, t in a.items()}, "head_dim"),
    ("sequence-major 3-D", lambda a: dict(q=a["q"][0]), "head-major"),
    ("sequence lengths", lambda a: dict(k=a["k"][:, :, :128].contiguous(),
                                        v=a["v"][:, :, :128].contiguous()),
     "sequence"),
    ("cpu", lambda a: {}, "CPU"),
])
def test_cuda_wrapper_refuses(what, over, match):
    """Every input the kernel does not take raises ``ValueError`` in the
    wrapper -- and so does a CPU tensor: it never falls back."""
    args = _args(**over(_args()))
    with pytest.raises(ValueError, match=match):
        fa.flash_attention(**args)


@pytest.mark.parametrize("kw,match", [
    (dict(sliding_window=-1), "negative"),
    (dict(block_q=0), "positive"),
])
def test_cuda_wrapper_refuses_arguments(kw, match):
    with pytest.raises(ValueError, match=match):
        fa.flash_attention(**_args(), **kw)


def test_cuda_wrapper_refuses_shared_memory_over_the_limit(monkeypatch):
    monkeypatch.setattr(fa, "MAX_SMEM_BYTES", fa.smem_bytes(64) - 1)
    with pytest.raises(ValueError, match="shared memory"):
        fa.flash_attention(**_args())
