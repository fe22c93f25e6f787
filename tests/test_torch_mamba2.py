"""The port's Mamba-2 block (``repro_torch.models.mamba2``) and Zamba2-style
hybrid (``repro_torch.models.hybrid``) against the reference's, at module
level on identical input bits with the reference's parameters carried over.
The whole hybrid model through the zoo is in ``test_torch_zoo.py``.

Tolerances: the float32 SSD recurrence within ``SSD_F32_TOL`` of the
largest magnitude (the same chunked products summed in another order);
bfloat16 block outputs within ``MODEL_TOL``; the depthwise conv (four
bfloat16 products and sums, no reduction) bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import hybrid as ref_hybrid
from repro.models import mamba2 as ref_mamba
from repro_torch.models import hybrid, mamba2
from repro_torch.models.layers import take_layer

from _torch_model_cases import (MODEL_TOL, carried, configs, f32, max_rel,
                                spec_leaves)

SSD_F32_TOL = 1e-5


def _ssd_inputs(B, S, H, D, N, seed=0):
    rng = np.random.default_rng(seed)
    xbar = rng.standard_normal((B, S, H, D))
    Bh, Ch = (rng.standard_normal((B, S, H, N)) for _ in range(2))
    la = -np.exp(rng.standard_normal((B, S, H)) - 1.0)
    s0 = rng.standard_normal((B, H, D, N))
    return [a.astype(np.float32) for a in (xbar, Bh, Ch, la, s0)]


@pytest.mark.parametrize("S", [32, 40, 9])
@pytest.mark.parametrize("carry", [False, True], ids=["zero-state", "state0"])
def test_ssd_chunked_matches_reference(S, carry):
    xbar, Bh, Ch, la, s0 = _ssd_inputs(2, S, 3, 8, 16)
    st = s0 if carry else None
    ya, fa = ref_mamba.ssd_chunked(*map(jnp.asarray, (xbar, Bh, Ch, la)), 16,
                                   None if st is None else jnp.asarray(st))
    yb, fb = mamba2.ssd_chunked(*map(torch.from_numpy, (xbar, Bh, Ch, la)),
                                16, None if st is None else
                                torch.from_numpy(st))
    assert tuple(yb.shape) == (2, S, 3, 8) and tuple(fb.shape) == (2, 3, 8, 16)
    assert max_rel(yb, ya) < SSD_F32_TOL
    assert max_rel(fb, fa) < SSD_F32_TOL


@pytest.fixture(scope="module")
def block():
    rcfg, cfg = configs("zamba2-7b")
    rp, pp = carried(rcfg)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 20, cfg.d_model)).astype(np.float32)
    d_inner, H, G, N, conv_dim, _ = mamba2.dims(cfg)
    st = (0.1 * rng.standard_normal((2, H, cfg.ssm_head_dim, N))
          ).astype(np.float32)
    conv = rng.standard_normal((2, mamba2.CONV_K - 1, conv_dim)
                               ).astype(np.float32)
    return (rcfg, cfg, rp, pp, jax.tree.map(lambda a: a[2], rp["mamba"]),
            take_layer(pp["mamba"], 2), x, st, conv)


@pytest.mark.parametrize("cached", [False, True], ids=["no-cache", "cache"])
def test_conv_matches_reference_bit_for_bit(block, cached):
    rcfg, cfg, _, _, rlw, plw, x, _, conv = block
    d_inner, H, G, N, conv_dim, _ = mamba2.dims(cfg)
    xbc = x[..., :1].repeat(conv_dim, -1) * np.linspace(-1, 1, conv_dim,
                                                        dtype=np.float32)
    cache_r = jnp.asarray(conv, jnp.bfloat16) if cached else None
    cache_p = torch.from_numpy(conv).bfloat16() if cached else None
    ya, ca = ref_mamba._conv(jnp.asarray(xbc, jnp.bfloat16), rlw, cache_r)
    yb, cb = mamba2._conv(torch.from_numpy(xbc).bfloat16(), plw, cache_p)
    assert np.array_equal(f32(yb), f32(ya))
    assert np.array_equal(f32(cb), f32(ca))
    assert tuple(cb.shape) == (2, mamba2.CONV_K - 1, conv_dim)


def test_ssm_inputs_repeat_each_group_over_its_heads(block):
    """With two groups the B and C heads repeat group by group
    (``jnp.repeat`` is ``repeat_interleave``, not ``Tensor.repeat``)."""
    rcfg, cfg, _, _, rlw, plw, x, _, _ = block
    rcfg, cfg = rcfg.replace(ssm_groups=2), cfg.replace(ssm_groups=2)
    d_inner, H, G, N, conv_dim, _ = mamba2.dims(cfg)
    rng = np.random.default_rng(5)
    xbc = rng.standard_normal((2, 6, conv_dim)).astype(np.float32)
    dt = rng.standard_normal((2, 6, H)).astype(np.float32)
    want = ref_mamba._ssm_inputs(jnp.asarray(xbc, jnp.bfloat16),
                                 jnp.asarray(dt, jnp.bfloat16), rlw, rcfg)
    got = mamba2._ssm_inputs(torch.from_numpy(xbc).bfloat16(),
                             torch.from_numpy(dt).bfloat16(), plw, cfg)
    for a, b in zip(want, got):
        assert tuple(b.shape) == a.shape
        assert max_rel(b, a) < 1e-6
    assert not torch.equal(got[2][:, :, 0], got[2][:, :, -1])


def test_block_forward_matches_reference(block):
    rcfg, cfg, _, _, rlw, plw, x, st, conv = block
    ya, (fa, ca) = ref_mamba.block_forward(
        jnp.asarray(x, jnp.bfloat16), rlw, rcfg, jnp.asarray(st),
        jnp.asarray(conv, jnp.bfloat16))
    yb, (fb, cb) = mamba2.block_forward(
        torch.from_numpy(x).bfloat16(), plw, cfg, torch.from_numpy(st),
        torch.from_numpy(conv).bfloat16())
    np.testing.assert_allclose(f32(yb), f32(ya), atol=MODEL_TOL, rtol=0)
    assert max_rel(fb, fa) < 1e-2
    assert np.array_equal(f32(cb), f32(ca))


def test_block_decode_matches_reference(block):
    rcfg, cfg, _, _, rlw, plw, x, st, conv = block
    ya, (fa, ca) = ref_mamba.block_decode(
        jnp.asarray(x[:, :1], jnp.bfloat16), rlw, rcfg, jnp.asarray(st),
        jnp.asarray(conv, jnp.bfloat16))
    yb, (fb, cb) = mamba2.block_decode(
        torch.from_numpy(x[:, :1]).bfloat16(), plw, cfg,
        torch.from_numpy(st), torch.from_numpy(conv).bfloat16())
    np.testing.assert_allclose(f32(yb), f32(ya), atol=MODEL_TOL, rtol=0)
    assert max_rel(fb, fa) < 1e-2
    assert np.array_equal(f32(cb), f32(ca))


@pytest.mark.parametrize("arch,over", [
    ("zamba2-7b", {}), ("zamba2-7b", {"n_layers": 81, "attn_every": 6}),
    ("zamba2-7b", {"n_layers": 8, "attn_every": 4})])
def test_hybrid_layer_plan_matches_reference(arch, over):
    rcfg, cfg = configs(arch, **over)
    assert hybrid.plan_layers(cfg) == ref_hybrid.plan_layers(rcfg)
    assert hybrid._segments(cfg) == ref_hybrid._segments(rcfg)
    assert spec_leaves(hybrid.param_specs(cfg)) == spec_leaves(
        ref_hybrid.param_specs(rcfg))


def test_hybrid_init_cache_matches_reference():
    rcfg, cfg = configs("zamba2-7b")
    want = ref_hybrid.init_cache(rcfg, 2, 16)
    got = hybrid.init_cache(cfg, 2, 16, device="cpu")
    assert jax.tree.map(lambda a: a.shape, want) == {
        "ssm": {k: tuple(v.shape) for k, v in got["ssm"].items()},
        **{k: tuple(got[k].shape) for k in ("k", "v", "pos")}}
