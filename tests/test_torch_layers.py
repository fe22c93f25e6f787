"""The port's model building blocks (``repro_torch.models.layers``) against
the reference's (``repro.models.layers``) on the same inputs, drawn by numpy
from a seed.  Tolerance: ``tests/test_kernels.py::_tol`` -- 3e-2 absolute in
bfloat16, 5e-5 in float32 -- on outputs of order one."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.models import layers as ref
from repro.models import transformer as ref_tf
from repro_torch.configs import ARCHS
from repro_torch.models import layers as port
from repro_torch.models import transformer as tf

from _torch_kernel_cases import PAGED_TOL

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def both(a, dt):
    """One numpy array as a jax array and a torch tensor of dtype ``dt``
    (both round float32 to bfloat16 to nearest even: the same bits)."""
    a = np.asarray(a, np.float32)
    return jnp.asarray(a, DTYPES[dt][0]), torch.from_numpy(a).to(DTYPES[dt][1])


def f32(x):
    if torch.is_tensor(x):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def assert_close(got, want, dt):
    assert got.dtype == DTYPES[dt][1]
    np.testing.assert_allclose(f32(got), f32(want), atol=PAGED_TOL[dt],
                               rtol=0)


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_rms_norm_and_layer_norm(dt):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)) * 3 + 0.5
    g = 1 + 0.1 * rng.standard_normal(64)
    b = 0.1 * rng.standard_normal(64)
    (xj, xt), (gj, gt), (bj, bt) = both(x, dt), both(g, dt), both(b, dt)
    assert_close(port.rms_norm(xt, gt), ref.rms_norm(xj, gj), dt)
    assert_close(port.layer_norm(xt, gt, bt), ref.layer_norm(xj, gj, bj), dt)


@pytest.mark.parametrize("theta", [1e4, 1e6])
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_rope(dt, theta):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 3, 32))
    pos = rng.integers(0, 1000, (2, 7)).astype(np.int32)
    xj, xt = both(x, dt)
    got = port.rope(xt, torch.from_numpy(pos), theta)
    want = ref.rope(xj, jnp.asarray(pos), theta)
    assert_close(got, want, dt)


@pytest.mark.parametrize("kind", ["swiglu", "gelu"])
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_mlp(dt, kind):
    rng = np.random.default_rng(2)
    d, ff = 64, 128
    x = rng.standard_normal((2, 5, d))
    names = (("wi_gate", (d, ff)), ("wi_up", (d, ff)), ("wo", (ff, d))) \
        if kind == "swiglu" else (("wi", (d, ff)), ("wo", (ff, d)))
    wj, wt = {}, {}
    for name, shape in names:
        w = rng.standard_normal(shape) / math.sqrt(shape[0])
        wj[name], wt[name] = both(w, dt)
    xj, xt = both(x, dt)
    assert_close(port.mlp(xt, wt, kind), ref.mlp(xj, wj, kind), dt)


ATTN_CASES = {
    # name: (S, causal, window, block_kv); S > block_kv takes the blockwise
    # online-softmax path (with a padded last block where S % block_kv)
    "dense-causal": (48, True, None, 64),
    "dense-full": (48, False, None, 64),
    "dense-window": (48, True, 16, 64),
    "blockwise-causal": (160, True, None, 64),
    "blockwise-full": (160, False, None, 64),
    "blockwise-window": (200, True, 40, 64),
}


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("name", sorted(ATTN_CASES))
def test_attention(name, dt):
    S, causal, win, block = ATTN_CASES[name]
    rng = np.random.default_rng(3)
    B, Hq, Hkv, D = 2, 4, 2, 32
    (qj, qt), (kj, kt), (vj, vt) = (
        both(rng.standard_normal((B, S, h, D)), dt) for h in (Hq, Hkv, Hkv))
    got = port.attention(qt, kt, vt, causal=causal, sliding_window=win,
                         block_kv=block)
    want = ref.attention(qj, kj, vj, causal=causal, sliding_window=win,
                         block_kv=block)
    assert got.shape == (B, S, Hq, D)
    assert_close(got, want, dt)


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("hq", [2, 8])
def test_decode_attention(hq, dt):
    rng = np.random.default_rng(4)
    B, S_max, Hkv, D = 3, 40, 2, 32
    qj, qt = both(rng.standard_normal((B, 1, hq, D)), dt)
    kj, kt = both(rng.standard_normal((B, S_max, Hkv, D)), dt)
    vj, vt = both(rng.standard_normal((B, S_max, Hkv, D)), dt)
    lens = np.array([0, 17, 40], np.int32)        # one fully masked row
    got = port.decode_attention(qt, kt, vt, torch.from_numpy(lens))
    want = ref.decode_attention(qj, kj, vj, jnp.asarray(lens))
    assert_close(got, want, dt)
    assert float(got[0].float().abs().max()) == 0.0
    # a scalar cache length, as the dense decode step passes it
    assert_close(port.decode_attention(qt, kt, vt, 23),
                 ref.decode_attention(qj, kj, vj, 23), dt)


def _spec_tree(specs, leaf):
    if isinstance(specs, dict):
        return {k: _spec_tree(v, leaf) for k, v in specs.items()}
    return leaf(specs)


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "starcoder2-3b",
                                  "llama3-405b", "qwen1.5-110b"])
def test_param_specs_match_reference(arch):
    """Same tree, shapes, logical axes and init rule as the reference."""
    def leaf(s):
        return (tuple(s.shape), tuple(s.axes), s.init)
    got = _spec_tree(tf.param_specs(ARCHS[arch]), leaf)
    want = _spec_tree(ref_tf.param_specs(REF_ARCHS[arch]), leaf)
    assert got == want


def test_init_params_scales_and_determinism():
    specs = {"embed": port.ParamSpec((512, 256), ("vocab", "embed"),
                                     init="embed"),
             "w": port.ParamSpec((3, 256, 1024), ("layers", "embed", "mlp")),
             "b": port.ParamSpec((3, 8), ("layers", None), init="zeros"),
             "g": port.ParamSpec((8,), ("embed",), init="ones")}
    p = port.init_params(specs, torch.Generator().manual_seed(7))
    assert list(p) == sorted(specs)
    for k, v in p.items():
        assert v.dtype == torch.bfloat16 and tuple(v.shape) == specs[k].shape
    # embed: 1/sqrt(last dim); fan_in: 1/sqrt(penultimate dim)
    assert abs(float(p["embed"].float().std()) * math.sqrt(256) - 1) < 0.02
    assert abs(float(p["w"].float().std()) * math.sqrt(256) - 1) < 0.02
    assert float(p["b"].float().abs().max()) == 0.0
    assert float(p["g"].float().min()) == 1.0
    again = port.init_params(specs, torch.Generator().manual_seed(7))
    assert all(torch.equal(p[k], again[k]) for k in p)
    ref_p = ref.init_params(
        {"w": ref.ParamSpec((3, 256, 1024), ("layers", "embed", "mlp"))},
        jax.random.PRNGKey(0))
    # the reference draws at the same scale (different numbers)
    assert abs(float(np.asarray(ref_p["w"], np.float32).std())
               / float(p["w"].float().std()) - 1) < 0.02
