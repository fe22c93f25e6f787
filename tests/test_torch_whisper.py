"""The port's Whisper-style encoder-decoder (``repro_torch.models.whisper``)
against the reference's (``repro.models.whisper``) at module level, with the
reference's parameters carried over: the sinusoid table bit for bit, the
vocabulary padding, the tanh-GELU FFN and the cross-attention on identical
input bits, and the encoder and the cross-attention K/V within
``MODEL_TOL``.  The whole model through the zoo is in
``test_torch_zoo.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import whisper as ref_whisper
from repro_torch.configs import ARCHS
from repro_torch.models import whisper
from repro_torch.models.layers import take_layer

from _torch_model_cases import MODEL_TOL, carried, configs, f32


@pytest.mark.parametrize("T,d", [(24, 128), (7, 10)])
def test_sinusoid_matches_reference_bit_for_bit(T, d):
    """At the smoke configs' sizes the tables are equal bit for bit."""
    want = ref_whisper._sinusoid(T, d)
    got = whisper._sinusoid(T, d)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    assert np.array_equal(f32(got), f32(want))


def test_sinusoid_at_full_width_within_one_bfloat16_step():
    """whisper-small's table (1500 frames, d 768): XLA-CPU's and PyTorch's
    float32 ``exp``, ``sin`` and ``cos`` differ in the last place at some
    arguments, and where that straddles a bfloat16 rounding boundary the
    entries differ by one bfloat16 step (2**-8 below 1).  283 of the
    1 152 000 entries do (``ROADMAP.md`` C20); every entry is within one
    step and fewer than 0.1 % differ."""
    want = f32(ref_whisper._sinusoid(1500, 768))
    got = f32(whisper._sinusoid(1500, 768))
    diff = np.abs(got - want)
    assert float(diff.max()) <= 2.0 ** -8
    assert int((diff > 0).sum()) < 0.001 * want.size


def test_padded_vocab_and_head_width():
    cfg = ARCHS["whisper-small"]
    assert whisper.padded_vocab(cfg) == 51872
    assert whisper.param_specs(cfg)["embed"].shape == (51872, 768)


@pytest.fixture(scope="module")
def model():
    rcfg, cfg = configs("whisper-small")
    rp, pp = carried(rcfg)
    rng = np.random.default_rng(6)
    frames = (0.02 * rng.standard_normal((2, cfg.n_frames, cfg.d_model))
              ).astype(np.float32)
    x = rng.standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    return rcfg, cfg, rp, pp, frames, x


def test_ffn_is_tanh_gelu_as_the_reference(model):
    rcfg, cfg, rp, pp, _, x = model
    rlw = jax.tree.map(lambda a: a[0], rp["dec"])
    plw = take_layer(pp["dec"], 0)
    want = ref_whisper._ffn(jnp.asarray(x, jnp.bfloat16), rlw)
    got = whisper._ffn(torch.from_numpy(x).bfloat16(), plw)
    np.testing.assert_allclose(f32(got), f32(want), atol=MODEL_TOL, rtol=0)
    erf = torch.nn.functional.gelu(torch.tensor([-1.5, 0.7]))
    tanh = torch.nn.functional.gelu(torch.tensor([-1.5, 0.7]),
                                    approximate="tanh")
    ref = jax.nn.gelu(jnp.asarray([-1.5, 0.7]))
    assert np.allclose(np.asarray(ref), tanh.numpy(), atol=1e-7)
    assert not np.allclose(np.asarray(ref), erf.numpy(), atol=1e-4)


def test_cross_attention_matches_reference(model):
    rng = np.random.default_rng(7)
    q = rng.standard_normal((2, 5, 4, 32)).astype(np.float32)
    k, v = (rng.standard_normal((2, 24, 4, 32)).astype(np.float32)
            for _ in range(2))
    want = ref_whisper._cross_attn(*(jnp.asarray(a, jnp.bfloat16)
                                     for a in (q, k, v)))
    got = whisper._cross_attn(*(torch.from_numpy(a).bfloat16()
                                for a in (q, k, v)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(f32(got), f32(want), atol=MODEL_TOL, rtol=0)


def test_encode_and_cross_kv_match_reference(model):
    rcfg, cfg, rp, pp, frames, _ = model
    enc_r = ref_whisper.encode(rp, jnp.asarray(frames), rcfg)
    enc_p = whisper.encode(pp, torch.from_numpy(frames), cfg)
    np.testing.assert_allclose(f32(enc_p), f32(enc_r), atol=MODEL_TOL, rtol=0)
    xk_r, xv_r = ref_whisper.precompute_cross_kv(rp, enc_r, rcfg)
    xk_p, xv_p = whisper.precompute_cross_kv(pp, enc_p, cfg)
    for a, b in ((xk_p, xk_r), (xv_p, xv_r)):
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(f32(a), f32(b), atol=MODEL_TOL, rtol=0)


def test_init_cache_matches_reference():
    rcfg, cfg = configs("whisper-small")
    want = ref_whisper.init_cache(rcfg, 2, 16, 24)
    got = whisper.init_cache(cfg, 2, 16, 24, device="cpu")
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        k: v.shape for k, v in want.items()}
