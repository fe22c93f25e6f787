"""The port's model zoo (``repro_torch.zoo.get_api``) against the
reference's (``repro.zoo.get_api``) for all ten architectures at their smoke
configs, with the reference's parameters carried over bit for bit and the
same numpy batches, and the reference's model contracts
(``tests/test_models.py``) ported to the port.

* Logits of ``get_api(cfg).logits`` against the reference's jitted ones
  within ``MODEL_TOL`` (0.125 absolute on bfloat16 logits), save the two
  families of ``FAMILY_TOL`` (reason and worst values in
  ``tests/_torch_model_cases.py``).
* One ``decode`` step against the reference's from the same carried cache
  (filled by three reference steps): logits and the new cache's bfloat16
  leaves within the same bound, its float32 states within a quarter of it
  relative to their largest magnitude (the bound's share of logits of
  order 4), ``pos`` equal.  Worst seen: MoE K/V 1.13 (a routed expert
  flipped in an earlier layer), RWKV-6 state 1.3 %, Mamba-2 state 0.64 %.
* ``TestSmoke`` (shapes, finite), ``test_decode_matches_forward`` (its six
  archs and qwen2-moe-a2.7b, at the reference's ``PARITY_TOL``, MoE at
  capacity factor 64) and ``test_sliding_window_ring_parity`` run on the
  port alone, as the reference runs them on itself.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.models import whisper as ref_whisper
from repro_torch.configs import ARCHS, smoke_config
from repro_torch.models import transformer as tf
from repro_torch.models import whisper
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.layers import init_params

from _torch_model_cases import (ARCH_NAMES, B, MODEL_TOL, PARITY_TOL, S,
                                as_jax, as_torch, batch, carried, configs,
                                f32, get_api, max_rel, model_tol,
                                ref_get_api, spec_leaves, to_numpy_tree)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_specs_match_reference_at_full_width(arch):
    want = ref_get_api(REF_ARCHS[arch]).param_specs(REF_ARCHS[arch])
    assert spec_leaves(get_api(ARCHS[arch]).param_specs(ARCHS[arch])) == \
        spec_leaves(want)


@pytest.fixture(scope="module", params=ARCH_NAMES)
def arch_case(request):
    rcfg, cfg = configs(request.param)
    rp, pp = carried(rcfg)
    b = batch(cfg)
    want, aux = jax.jit(lambda p, bb: ref_get_api(rcfg).logits(p, bb, rcfg))(
        rp, as_jax(b))
    return rcfg, cfg, rp, pp, b, want, aux


def test_logits_match_reference(arch_case):
    rcfg, cfg, rp, pp, b, want, aux_r = arch_case
    got, aux = get_api(cfg).logits(pp, as_torch(b), cfg)
    s_total = S + (cfg.n_patches if cfg.family == "vlm" else 0)
    assert tuple(got.shape) == want.shape == (B, s_total, cfg.vocab)
    assert got.dtype == torch.bfloat16
    assert aux.dtype == torch.float32 and aux.shape == ()
    np.testing.assert_allclose(f32(got), f32(want), atol=model_tol(cfg),
                               rtol=0)
    assert abs(float(aux) - float(aux_r)) < MODEL_TOL


def _ref_cache(rcfg, rp, b, max_len):
    api = ref_get_api(rcfg)
    cache = api.init_cache(rcfg, B, max_len)
    if rcfg.family == "encdec":
        enc = ref_whisper.encode(rp, jnp.asarray(b["frames"]), rcfg)
        cache["xk"], cache["xv"] = ref_whisper.precompute_cross_kv(rp, enc,
                                                                   rcfg)
    return cache


def test_decode_step_matches_reference(arch_case):
    rcfg, cfg, rp, pp, b, _, _ = arch_case
    dec = jax.jit(lambda p, c, t: ref_get_api(rcfg).decode(p, c, t, rcfg))
    cache = _ref_cache(rcfg, rp, b, 8)
    toks = b["tokens"]
    for i in range(3):
        _, cache = dec(rp, cache, jnp.asarray(toks[:, i:i + 1]))
    pc = params_from_numpy(to_numpy_tree(cache), device="cpu")
    want, cache_r = dec(rp, cache, jnp.asarray(toks[:, 3:4]))
    before = jax.tree.leaves(pc)
    before = [t.clone() for t in before]
    got, cache_p = get_api(cfg).decode(pp, pc, torch.from_numpy(toks[:, 3:4]),
                                       cfg)
    assert all(torch.equal(a, c) for a, c in zip(before, jax.tree.leaves(pc)))
    assert tuple(got.shape) == want.shape == (B, 1, cfg.vocab)
    np.testing.assert_allclose(f32(got), f32(want), atol=model_tol(cfg),
                               rtol=0)
    ref_leaves = jax.tree_util.tree_flatten_with_path(cache_r)[0]
    port_leaves = jax.tree.leaves(cache_p)
    assert len(ref_leaves) == len(port_leaves)
    for (path, a), t in zip(ref_leaves, port_leaves):
        name = jax.tree_util.keystr(path)
        assert tuple(t.shape) == a.shape, name
        if t.dtype == torch.int32:
            assert np.array_equal(t.numpy(), np.asarray(a)), name
        elif t.dtype == torch.bfloat16:
            np.testing.assert_allclose(f32(t), f32(a), atol=model_tol(cfg),
                                       rtol=0, err_msg=name)
        else:
            assert max_rel(t, a) <= model_tol(cfg) / 4, name


# -- the reference's model contracts (tests/test_models.py), on the port ------

@pytest.mark.parametrize("arch", ARCH_NAMES)
class TestSmoke:
    def test_forward_shapes_and_finite(self, arch):
        cfg = smoke_config(ARCHS[arch])
        api = get_api(cfg)
        params = init_params(api.param_specs(cfg),
                             torch.Generator().manual_seed(0))
        logits, aux = api.logits(params, as_torch(batch(cfg)), cfg)
        s_total = S + (cfg.n_patches if cfg.family == "vlm" else 0)
        assert tuple(logits.shape) == (B, s_total, cfg.vocab)
        assert bool(torch.isfinite(logits.float()).all())
        assert bool(torch.isfinite(aux))

    def test_decode_step_runs(self, arch):
        cfg = smoke_config(ARCHS[arch])
        api = get_api(cfg)
        params = init_params(api.param_specs(cfg),
                             torch.Generator().manual_seed(0))
        cache = api.init_cache(cfg, B, 64, device="cpu")
        if cfg.family == "encdec":
            frames = torch.from_numpy(batch(cfg)["frames"])
            enc = whisper.encode(params, frames, cfg)
            cache["xk"], cache["xv"] = whisper.precompute_cross_kv(
                params, enc, cfg)
        lg, cache2 = api.decode(params, cache,
                                torch.ones((B, 1), dtype=torch.int32), cfg)
        assert tuple(lg.shape) == (B, 1, cfg.vocab)
        assert bool(torch.isfinite(lg.float()).all())
        assert int(cache2["pos"][0]) == 1


def _step_vs_forward(arch, over, Sp, max_len):
    """The reference test's protocol on the port: carried PRNGKey(1)
    parameters, the reference's token draw, a teacher-forced forward and
    ``Sp`` decode steps; returns (max relative difference, cache)."""
    rcfg, cfg = configs(arch, **over)
    _, params = carried(rcfg, key=1)
    toks = np.array(jax.random.randint(jax.random.PRNGKey(0), (B, Sp), 0,
                                       cfg.vocab))
    b = {"tokens": torch.from_numpy(toks)}
    if cfg.family == "encdec":
        b["frames"] = torch.from_numpy(np.array(jax.random.normal(
            jax.random.PRNGKey(2), (B, cfg.n_frames, cfg.d_model)) * 0.02))
    api = get_api(cfg)
    full, _ = api.logits(params, b, cfg, remat=False)
    cache = api.init_cache(cfg, B, max_len, device="cpu")
    if cfg.family == "encdec":
        enc = whisper.encode(params, b["frames"], cfg)
        cache["xk"], cache["xv"] = whisper.precompute_cross_kv(params, enc,
                                                               cfg)
    outs = []
    for i in range(Sp):
        lg, cache = api.decode(params, cache, b["tokens"][:, i:i + 1], cfg)
        outs.append(lg[:, 0])
    return max_rel(torch.stack(outs, dim=1), full), cache


@pytest.mark.parametrize(
    "arch", ["qwen2.5-3b", "starcoder2-3b", "deepseek-moe-16b", "zamba2-7b",
             "rwkv6-3b", "whisper-small", "qwen2-moe-a2.7b"])
def test_decode_matches_forward(arch):
    """Step-by-step decode reproduces the teacher-forced forward pass."""
    over = ({"capacity_factor": 64.0}
            if ARCHS[arch].family == "moe" else {})
    rel, _ = _step_vs_forward(arch, over, 10, 12)
    assert rel < PARITY_TOL[arch], rel


def test_sliding_window_ring_parity():
    """Ring-buffer decode == full forward with the same sliding window (20
    steps through a ring of 8: it wraps twice)."""
    rel, cache = _step_vs_forward("starcoder2-3b", {"sliding_window": 8}, 20,
                                  20)
    assert cache["k"].shape[2] == 8
    assert rel < 1e-2, rel


@pytest.mark.parametrize("arch,tol", [("rwkv6-3b", 1e-3),
                                      ("zamba2-7b", 1e-4),
                                      ("deepseek-moe-16b", 1e-4)])
def test_decode_matches_forward_in_float32_at_depth(monkeypatch, arch, tol):
    """At 16 layers and 40 tokens the bfloat16 models miss ``PARITY_TOL``
    (the port 0.214 / 0.0071 / 0.152, the reference 0.467 / 0.0547 /
    0.0839 on its own CPU run): rounding amplified through the layers, and
    flipped routes.  With every module in float32 the port's decode
    reproduces its forward (worst seen 1.6e-4, 4.3e-6, 1.6e-6; ``ROADMAP.md``
    C21)."""
    from repro_torch.models import (hybrid, layers, mamba2, moe, rwkv6,
                                    vlm)
    for mod in (layers, tf, rwkv6, mamba2, hybrid, moe, whisper, vlm):
        if hasattr(mod, "DTYPE"):
            monkeypatch.setattr(mod, "DTYPE", torch.float32)
    cfg = smoke_config(ARCHS[arch]).replace(n_layers=16, capacity_factor=64.0)
    api = get_api(cfg)
    params = layers.map_tree(lambda t: t.float(), init_params(
        api.param_specs(cfg), torch.Generator().manual_seed(0)))
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (B, 40)))
    full, _ = api.logits(params, {"tokens": toks}, cfg)
    cache = layers.map_tree(
        lambda t: t.float() if t.is_floating_point() else t,
        api.init_cache(cfg, B, 40, device="cpu"))
    outs = []
    for i in range(40):
        lg, cache = api.decode(params, cache, toks[:, i:i + 1], cfg)
        outs.append(lg[:, 0])
    assert full.dtype == torch.float32
    assert max_rel(torch.stack(outs, dim=1), full) < tol


# -- the transformer's forward and the zoo's plumbing --------------------------

def test_transformer_forward_last_only_and_prefix():
    rcfg, cfg = configs("llava-next-mistral-7b")
    _, pp = carried(rcfg)
    b = as_torch(batch(cfg))
    prefix = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (B, 5, cfg.d_model)).astype(np.float32))
    full = tf.forward(pp, b["tokens"], cfg, prefix_embeds=prefix)
    last = tf.forward(pp, b["tokens"], cfg, prefix_embeds=prefix,
                      last_only=True)
    assert tuple(full.shape) == (B, S + 5, cfg.vocab)
    assert torch.equal(last, full[:, -1:])


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_init_cache_defaults_to_the_card(arch):
    cfg = smoke_config(ARCHS[arch])
    api = get_api(cfg)
    if torch.cuda.is_available():
        cache = api.init_cache(cfg, 1, 8)
        assert all(t.is_cuda for t in jax.tree.leaves(cache))
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.init_cache(cfg, 1, 8)
    cache = api.init_cache(cfg, 1, 8, device="cpu")
    assert all(t.device.type == "cpu" for t in jax.tree.leaves(cache))
