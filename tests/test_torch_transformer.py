"""The port's dense transformer (``repro_torch.models.transformer``) against
the reference's (``repro.models.transformer``): the reference's parameters,
drawn by its ``init_params`` from ``PRNGKey(0)``, carried over bit for bit,
and the same token ids.

Tolerance: ``MODEL_TOL`` = 0.125 absolute on bfloat16 logits and K/V cache
entries (``tests/_torch_kernel_cases.py`` gives the reason).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import smoke_config as ref_smoke_config
from repro.models import transformer as ref_tf
from repro.models.layers import init_params as ref_init_params
from repro_torch.configs import ARCHS, smoke_config
from repro_torch.models import transformer as tf
from repro_torch.models.convert import params_from_numpy, tensor_from_numpy

from _torch_kernel_cases import MODEL_TOL

#: name -> (arch, sliding window, prompt length, cache max_len)
VARIANTS = {
    "qwen-dense-prefill": ("qwen2.5-3b", None, 24, 32),
    "qwen-blockwise-prefill": ("qwen2.5-3b", None, 100, 110),
    "starcoder-ring-wraps": ("starcoder2-3b", 16, 40, 48),
    "starcoder-ring-unfilled": ("starcoder2-3b", 64, 20, 30),
}


def f32(x):
    if torch.is_tensor(x):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def model(request):
    arch, win, S, max_len = VARIANTS[request.param]
    rcfg = ref_smoke_config(REF_ARCHS[arch]).replace(sliding_window=win)
    cfg = smoke_config(ARCHS[arch]).replace(sliding_window=win)
    rp = ref_init_params(ref_tf.param_specs(rcfg), jax.random.PRNGKey(0))
    pp = params_from_numpy(jax.tree.map(np.asarray, rp), device="cpu")
    toks = np.random.default_rng(0).integers(1, cfg.vocab, (2, S))
    return rcfg, cfg, rp, pp, toks.astype(np.int32), max_len


def test_params_from_numpy_bit_exact(model):
    _, _, rp, pp, _, _ = model
    ref_leaves = jax.tree.leaves(rp)
    port_leaves = jax.tree.leaves(pp)
    assert len(ref_leaves) == len(port_leaves)
    for a, b in zip(ref_leaves, port_leaves):
        a = np.asarray(a)
        assert b.dtype == torch.bfloat16 and tuple(b.shape) == a.shape
        assert np.array_equal(a.view(np.uint16),
                              b.view(torch.int16).numpy().view(np.uint16))
    # read-only input arrays and float32 leaves carry over too
    ro = np.arange(6, dtype=np.float32)
    ro.setflags(write=False)
    assert torch.equal(tensor_from_numpy(ro), torch.arange(6.0))


def _prefill_both(model):
    rcfg, cfg, rp, pp, toks, max_len = model
    want = ref_tf.prefill(rp, jnp.asarray(toks), rcfg, max_len=max_len)
    got = tf.prefill(pp, torch.from_numpy(toks), cfg, max_len=max_len)
    return want, got


def test_prefill_matches_reference(model):
    (rl, rc), (pl, pc) = _prefill_both(model)
    assert tuple(pl.shape) == tuple(rl.shape)
    np.testing.assert_allclose(f32(pl), f32(rl), atol=MODEL_TOL, rtol=0)
    for name in ("k", "v"):
        assert tuple(pc[name].shape) == tuple(rc[name].shape)
        np.testing.assert_allclose(f32(pc[name]), f32(rc[name]),
                                   atol=MODEL_TOL, rtol=0)
    assert np.array_equal(pc["pos"].numpy(), np.asarray(rc["pos"]))


def test_decode_step_matches_reference(model):
    """Six dense decode steps after prefill, both fed the same tokens."""
    rcfg, cfg, rp, pp, toks, _ = model
    (_, rc), (_, pc) = _prefill_both(model)
    feed = np.random.default_rng(1).integers(1, cfg.vocab, (6, 2, 1))
    for t in range(6):
        tok = feed[t].astype(np.int32)
        rl, rc = ref_tf.decode_step(rp, rc, jnp.asarray(tok), rcfg)
        k_before = pc["k"].clone()
        pl, pc_new = tf.decode_step(pp, pc, torch.from_numpy(tok), cfg)
        assert torch.equal(pc["k"], k_before)     # the input cache is kept
        pc = pc_new
        np.testing.assert_allclose(f32(pl), f32(rl), atol=MODEL_TOL, rtol=0,
                                   err_msg=f"step {t}")
        assert np.array_equal(pc["pos"].numpy(), np.asarray(rc["pos"]))
    np.testing.assert_allclose(f32(pc["k"]), f32(rc["k"]), atol=MODEL_TOL,
                               rtol=0)


def test_init_cache_and_window():
    cfg = smoke_config(ARCHS["starcoder2-3b"])
    assert tf.cache_window(cfg, 1000) == cfg.sliding_window
    assert tf.cache_window(cfg.replace(sliding_window=None), 1000) == 1000
    c = tf.init_cache(cfg, 3, 40, device="cpu")
    assert tuple(c["k"].shape) == (cfg.n_layers, 3, 40, cfg.n_kv_heads,
                                   cfg.head_dim)
    assert c["k"].dtype == torch.bfloat16 and c["pos"].dtype == torch.int32


def test_default_device_is_the_card():
    """``init_cache`` and ``params_from_numpy`` default to ``device=None``,
    the card, and raise without one, as the port's other entry points do."""
    cfg = smoke_config(ARCHS["qwen2.5-3b"])
    tree = {"w": np.zeros(3, np.float32)}
    if torch.cuda.is_available():
        assert tf.init_cache(cfg, 1, 8)["k"].is_cuda
        assert params_from_numpy(tree)["w"].is_cuda
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tf.init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_numpy(tree)
    assert params_from_numpy(tree, device="cpu")["w"].device.type == "cpu"
