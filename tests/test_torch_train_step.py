"""The port's train step (``repro_torch.train.train_step``) against the
reference's: every architecture's smoke config takes a finite step, the
dense archs' first step from carried parameters agrees with the
reference's, microbatches accumulate to the same step, and training
resumes from a checkpoint bit for bit.

The reference's step is jitted and compiled at ``XLA_NO_FMA``
(``tests/_torch_port_support.py``): no fused multiply-adds, though XLA still
fuses bfloat16 elementwise operations and rounds once where the port rounds
each (``ROADMAP.md`` C22); its op-by-op run (``jax.disable_jit``) takes
about 25 s here, ten times the jitted one.  Tolerances, stated before the first run: the loss
within 2e-3 absolute; ``grad_norm`` within 2 %; every updated parameter
within 2 lr plus one bfloat16 step (the spacing at the larger of the two
values: each side rounds once, and the two may lie in adjacent binades) of
the reference's, at ``warmup=0`` (with a
warmup ``warmup_cosine`` gives lr 0 at step 0 and nothing moves).  After
one AdamW step an entry moves by lr times the sign of its gradient (plus
weight decay); where the gradient is about 0 the two packages may take
opposite signs, 2 lr apart, as the reference's own microbatch test allows
(``tests/test_train.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train.train_step import TrainHParams as RefHParams
from repro.train.train_step import init_train_state as ref_init_train_state
from repro.train.train_step import make_train_step as ref_make_train_step
from repro_torch.configs import ARCHS, smoke_config
from repro_torch.models.convert import train_state_from_numpy
from repro_torch.models.layers import init_params, map_tree
from repro_torch.train.checkpoint import restore, save
from repro_torch.train.train_step import (TrainHParams, init_train_state,
                                          make_train_step)
from repro_torch.tree import leaves
from repro_torch.zoo import get_api

from _torch_model_cases import carried, configs, f32, ref_get_api, \
    to_numpy_tree
from _torch_port_support import XLA_NO_FMA

B, S = 2, 32
LOSS_TOL = 2e-3
GNORM_REL = 0.02


def _batch(cfg, seed=1, seq=S):
    """The batch shapes of ``tests/test_models.py::_batch``, drawn by numpy:
    tokens (B, seq), targets and mask over the whole sequence (patches in
    front for the VLM)."""
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab, (B, seq)).astype(np.int32)}
    s_total = seq
    if cfg.family == "vlm":
        b["patches"] = (0.02 * rng.standard_normal(
            (B, cfg.n_patches, cfg.vision_dim))).astype(np.float32)
        s_total = seq + cfg.n_patches
    if cfg.family == "encdec":
        b["frames"] = (0.02 * rng.standard_normal(
            (B, cfg.n_frames, cfg.d_model))).astype(np.float32)
    b["targets"] = rng.integers(0, cfg.vocab, (B, s_total)).astype(np.int32)
    b["loss_mask"] = np.ones((B, s_total), np.float32)
    return b


def _bf16_step(w):
    """The spacing of bfloat16 values at ``|w|`` (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(w), 2.0 ** -126)))
    return 2.0 ** (e - 7)


def _torch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_train_step_no_nan(arch):
    cfg = smoke_config(ARCHS[arch])
    api = get_api(cfg)
    hp = TrainHParams(total_steps=10, warmup=1)
    step = make_train_step(api, cfg, hp)
    params = init_params(api.param_specs(cfg),
                         torch.Generator().manual_seed(0))
    state = init_train_state(params, hp)
    state, metrics = step(state, _torch(_batch(cfg)))
    assert bool(torch.isfinite(metrics["loss"]))
    assert bool(torch.isfinite(metrics["grad_norm"]))
    assert float(metrics["loss"]) < 2.0 * np.log(cfg.vocab)
    assert int(metrics["step"]) == 1 and int(state["opt"]["count"]) == 1
    assert all(bool(torch.isfinite(p.float()).all())
               for p in leaves(state["params"]))


def test_unused_leaves_get_zero_gradients():
    """llava without patches: its projector gets no gradient, and (as
    ``jax.grad`` gives zeros there) its moments stay 0 while weight decay
    alone moves it."""
    cfg = smoke_config(ARCHS["llava-next-mistral-7b"])
    api = get_api(cfg)
    hp = TrainHParams(total_steps=10, warmup=0)
    params = init_params(api.param_specs(cfg),
                         torch.Generator().manual_seed(0))
    b = _batch(smoke_config(ARCHS["qwen2.5-3b"]).replace(vocab=cfg.vocab))
    state, m = make_train_step(api, cfg, hp)(init_train_state(params, hp),
                                             _torch(b))
    proj = state["opt"]["m"]["projector"]
    assert len(proj) == 4 and all(not bool(x.any()) for x in proj.values())
    assert bool(state["opt"]["m"]["embed"].any())


def _ref_step(rcfg, rparams, hp_kw, batch):
    hp = RefHParams(**hp_kw)
    step = jax.jit(ref_make_train_step(ref_get_api(rcfg), rcfg, hp))
    args = (ref_init_train_state(rparams, hp),
            {k: jnp.asarray(v) for k, v in batch.items()})
    return step.lower(*args).compile(compiler_options=XLA_NO_FMA)(*args)


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "starcoder2-3b"])
def test_first_step_against_the_reference(arch):
    rcfg, cfg = configs(arch)
    rparams, params = carried(rcfg)
    hp_kw = dict(peak_lr=1e-3, warmup=0, total_steps=10)
    b = _batch(cfg, seq=96)       # S 96 > attn_block_kv 64: blockwise path
    rstate, rm = _ref_step(rcfg, rparams, hp_kw, b)
    state, m = make_train_step(get_api(cfg), cfg, TrainHParams(**hp_kw))(
        init_train_state(params, TrainHParams(**hp_kw)), _torch(b))
    assert abs(float(m["loss"]) - float(rm["loss"])) <= LOSS_TOL
    assert abs(float(m["grad_norm"]) / float(rm["grad_norm"]) - 1) \
        <= GNORM_REL
    lr = float(rm["lr"])
    assert lr == pytest.approx(1e-3) and float(m["lr"]) == lr
    moved = 0
    for got, want, before in zip(leaves(state["params"]),
                                 jax.tree.leaves(rstate["params"]),
                                 jax.tree.leaves(rparams)):
        g, w = f32(got), f32(want)
        step = _bf16_step(np.maximum(np.abs(g), np.abs(w)))
        assert np.all(np.abs(g - w) <= 2 * lr + step)
        moved += int((w != f32(before)).sum())
    assert moved > 0
    assert int(state["opt"]["count"]) == int(rstate["opt"]["count"]) == 1


def test_train_state_from_numpy_carries_every_bit():
    rcfg, cfg = configs("qwen2.5-3b")
    rparams, _ = carried(rcfg)
    rstate, _ = _ref_step(rcfg, rparams, dict(peak_lr=1e-3, warmup=0,
                                              total_steps=10),
                          _batch(cfg))
    state = train_state_from_numpy(to_numpy_tree(rstate), "cpu")
    for a, b in zip(leaves(state), jax.tree.leaves(rstate)):
        assert str(a.dtype).split(".")[1] == str(b.dtype)
        assert np.array_equal(f32(a).view(np.uint32),
                              f32(b).view(np.uint32))
    assert state["opt"]["count"].dtype == torch.int32
    with pytest.raises(ValueError, match="train state"):
        train_state_from_numpy({"params": {}}, "cpu")


def test_microbatch_equivalence():
    """mb=1 and mb=4 give (nearly) the same gradients -> same first step."""
    cfg = smoke_config(ARCHS["qwen2.5-3b"])
    api = get_api(cfg)
    rng = np.random.default_rng(1)
    t = rng.integers(0, cfg.vocab, (8, 17)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(t[:, :-1]),
             "targets": torch.from_numpy(t[:, 1:]),
             "loss_mask": torch.ones((8, 16))}
    outs = []
    for mb in (1, 4):
        hp = TrainHParams(peak_lr=1e-2, warmup=0, total_steps=10,
                          microbatches=mb)
        step = make_train_step(api, cfg, hp, accum_dtype=torch.float32)
        state = init_train_state(init_params(
            api.param_specs(cfg), torch.Generator().manual_seed(0)), hp)
        state, m = step(state, batch)
        outs.append(state["params"]["embed"])
    np.testing.assert_allclose(f32(outs[0]), f32(outs[1]), atol=2e-2)


def test_resume_determinism(tmp_path):
    """Train 6 steps straight == train 3, checkpoint, restore, train 3."""
    cfg = smoke_config(ARCHS["qwen2.5-3b"])
    api = get_api(cfg)
    hp = TrainHParams(peak_lr=1e-3, warmup=1, total_steps=6)
    step = make_train_step(api, cfg, hp)

    def batch(i):
        t = np.random.default_rng(100 + i).integers(
            0, cfg.vocab, (4, 17)).astype(np.int32)
        return {"tokens": torch.from_numpy(t[:, :-1]),
                "targets": torch.from_numpy(t[:, 1:]),
                "loss_mask": torch.ones((4, 16))}

    params = init_params(api.param_specs(cfg),
                         torch.Generator().manual_seed(0))
    s_a = init_train_state(params, hp)
    for i in range(6):
        s_a, _ = step(s_a, batch(i))

    s_b = init_train_state(params, hp)
    for i in range(3):
        s_b, _ = step(s_b, batch(i))
    save(str(tmp_path), 3, s_b)
    like = map_tree(lambda a: torch.empty_like(a, device="meta"), s_b)
    s_b = restore(str(tmp_path), 3, like, device="cpu")
    for i in range(3, 6):
        s_b, _ = step(s_b, batch(i))

    for a, b in zip(leaves(s_a), leaves(s_b)):
        assert torch.equal(a, b)


def test_step_donates_its_state():
    """The step updates the state's trees in place and returns the same
    dict; the caller's own parameter dict and tensors stay as they were."""
    cfg = smoke_config(ARCHS["qwen2.5-3b"])
    api = get_api(cfg)
    hp = TrainHParams(warmup=0)
    params = init_params(api.param_specs(cfg),
                         torch.Generator().manual_seed(0))
    before = map_tree(torch.clone, params)
    state = init_train_state(params, hp)
    new, _ = make_train_step(api, cfg, hp)(state, _torch(_batch(cfg)))
    assert new is state and state["params"] is not params
    assert not torch.equal(state["params"]["embed"], params["embed"])
    for a, b in zip(leaves(params), leaves(before)):
        assert torch.equal(a, b)
