"""The port's RWKV-6 (``repro_torch.models.rwkv6``) against the reference's
(``repro.models.rwkv6``) at module level, on identical input bits: the
chunked WKV recurrence, the time-mix in both branches and the token shift.
The whole model through the zoo is in ``test_torch_zoo.py``.

Tolerances: float32 recurrences within ``WKV_F32_TOL`` of the largest
magnitude (both sum the same chunked products in another order: the worst
seen is 5.2e-7); bfloat16 outputs within ``MODEL_TOL``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import rwkv6 as ref_rwkv
from repro_torch.kernels import ops
from repro_torch.models import rwkv6
from repro_torch.models.layers import take_layer

from _torch_kernel_cases import tol, wkv_err
from _torch_model_cases import MODEL_TOL, carried, configs, f32, max_rel

WKV_F32_TOL = 1e-5


def _wkv_inputs(B, S, H, D, seed=0):
    rng = np.random.default_rng(seed)
    r, k, v = (0.5 * rng.standard_normal((B, S, H, D)) for _ in range(3))
    lw = -np.exp(0.5 * rng.standard_normal((B, S, H, D)))
    u = 0.3 * rng.standard_normal((H, D))
    s0 = rng.standard_normal((B, H, D, D))
    return [a.astype(np.float32) for a in (r, k, v, lw, u, s0)]


@pytest.mark.parametrize("S", [32, 40, 7])
@pytest.mark.parametrize("carry", [False, True], ids=["zero-state", "state0"])
def test_wkv_chunked_matches_reference(S, carry):
    """S a multiple of the chunk, not one (padded), and below one chunk."""
    r, k, v, lw, u, s0 = _wkv_inputs(2, S, 2, 32)
    state0 = s0 if carry else None
    ya, fa = ref_rwkv.wkv_chunked(
        *map(jnp.asarray, (r, k, v, lw, u)), 16,
        None if state0 is None else jnp.asarray(state0))
    yb, fb = rwkv6.wkv_chunked(
        *map(torch.from_numpy, (r, k, v, lw, u)), 16,
        None if state0 is None else torch.from_numpy(state0))
    assert tuple(yb.shape) == (2, S, 2, 32) and fb.dtype == torch.float32
    assert max_rel(yb, ya) < WKV_F32_TOL
    assert max_rel(fb, fa) < WKV_F32_TOL


def test_wkv_chunked_agrees_with_the_kernels_plain_version():
    """The model's recurrence and ``kernels.ops.wkv6`` (on a CPU tensor: its
    plain sequential version) compute the same function."""
    r, k, v, lw, u, _ = (torch.from_numpy(a) for a in _wkv_inputs(2, 64, 2,
                                                                   32))
    y, _ = rwkv6.wkv_chunked(r, k, v, lw, u, 32)
    assert wkv_err(ops.wkv6(r, k, v, lw, u, chunk=32), y) < tol("float32")


@pytest.fixture(scope="module")
def layer():
    rcfg, cfg = configs("rwkv6-3b")
    rp, pp = carried(rcfg)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 20, cfg.d_model)).astype(np.float32)
    st = (0.1 * rng.standard_normal((2, cfg.n_rwkv_heads, cfg.rwkv_head_dim,
                                     cfg.rwkv_head_dim))).astype(np.float32)
    return (rcfg, cfg, jax.tree.map(lambda a: a[1], rp["layers"]),
            take_layer(pp["layers"], 1), x, st)


@pytest.mark.parametrize("decode", [False, True], ids=["chunked", "decode"])
def test_time_mix_matches_reference(layer, decode):
    rcfg, cfg, rlw, plw, x, st = layer
    if decode:
        x = x[:, :1]
    xr, xp = jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).bfloat16()
    prev = np.roll(x, 1, axis=1) * 0.5
    pr, pp = jnp.asarray(prev, jnp.bfloat16), torch.from_numpy(prev).bfloat16()
    s_r = jnp.asarray(st) if decode else None
    s_p = torch.from_numpy(st) if decode else None
    ya, fa = ref_rwkv._time_mix(xr, pr, rlw, rcfg, s_r, decode)
    yb, fb = rwkv6._time_mix(xp, pp, plw, cfg, s_p, decode)
    assert yb.dtype == torch.bfloat16 and tuple(yb.shape) == ya.shape
    np.testing.assert_allclose(f32(yb), f32(ya), atol=MODEL_TOL, rtol=0)
    assert fb.dtype == torch.float32
    assert max_rel(fb, fa) < WKV_F32_TOL


def test_shift_matches_reference():
    x = np.random.default_rng(3).standard_normal((2, 5, 8)).astype(np.float32)
    last = np.arange(16, dtype=np.float32).reshape(2, 8)
    for xs in (x, x[:, :1]):
        for lst in (None, last):
            want = ref_rwkv._shift(jnp.asarray(xs),
                                   None if lst is None else jnp.asarray(lst))
            got = rwkv6._shift(torch.from_numpy(xs),
                               None if lst is None else torch.from_numpy(lst))
            assert np.array_equal(got.numpy(), np.asarray(want))


def test_init_state_matches_reference():
    rcfg, cfg = configs("rwkv6-3b")
    want = ref_rwkv.init_state(rcfg, 3)
    got = rwkv6.init_state(cfg, 3, device="cpu")
    assert sorted(got) == sorted(want)
    for key in want:
        assert tuple(got[key].shape) == want[key].shape
        assert str(got[key].dtype).split(".")[-1] == str(want[key].dtype)
        assert not got[key].float().abs().max()
