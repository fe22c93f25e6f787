"""The port's training driver (``repro_torch.train.trainer.Trainer``): the
reference's learning test ported, the loss curve against the reference's
from the same initial parameters and batches, and resumption.

The loss-curve bound, stated before the first run: every one of the 30
steps' losses within 0.05 absolute of the reference's (losses of about 6.8
falling by about 0.3 in those steps; the two packages round bfloat16
differently, and where a gradient entry is about 0 its AdamW step may take
the other sign, so the parameters drift apart by a few lr a step)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.pipeline import DataConfig as RefDataConfig
from repro.data.pipeline import synthetic_batches as ref_batches
from repro.train.train_step import TrainHParams as RefHParams
from repro.train.train_step import init_train_state as ref_init_train_state
from repro.train.train_step import make_train_step as ref_make_train_step
from repro_torch.configs import ARCHS, smoke_config
from repro_torch.data.pipeline import DataConfig, synthetic_batches
from repro_torch.models.convert import train_state_from_numpy
from repro_torch.train.train_step import TrainHParams, make_train_step
from repro_torch.train.trainer import Trainer
from repro_torch.zoo import get_api

from _torch_model_cases import carried, configs, ref_get_api, to_numpy_tree
from _torch_port_support import XLA_NO_FMA

CURVE_TOL = 0.05
CURVE_STEPS = 30


def test_trainer_learns(tmp_path):
    cfg = smoke_config(ARCHS["qwen2.5-3b"])
    hp = TrainHParams(peak_lr=1e-3, warmup=10, total_steps=120)
    tr = Trainer(cfg, hp, ckpt_dir=str(tmp_path), ckpt_every=0,
                 device="cpu")
    tr.hp_global_batch, tr.hp_seq_len = 16, 48
    _, log = tr.fit(120, resume=False)
    first = np.mean([float(m["loss"]) for m in log[:10]])
    last = np.mean([float(m["loss"]) for m in log[-10:]])
    assert last < first - 1.0  # clearly learning the synthetic structure


def test_loss_curve_against_the_reference():
    """Smoke qwen2.5-3b, B 16 x S 48, the reference's initial parameters
    carried over, the same ``synthetic_batches``; the reference's step
    jitted at ``XLA_NO_FMA``."""
    rcfg, cfg = configs("qwen2.5-3b")
    rparams, _ = carried(rcfg)
    kw = dict(peak_lr=1e-3, warmup=10, total_steps=120)
    rhp, hp = RefHParams(**kw), TrainHParams(**kw)
    rstate = ref_init_train_state(rparams, rhp)
    state = train_state_from_numpy(to_numpy_tree(rstate), "cpu")
    rstep = ref_make_train_step(ref_get_api(rcfg), rcfg, rhp)
    step = make_train_step(get_api(cfg), cfg, hp)
    dkw = dict(global_batch=16, seq_len=48, vocab=cfg.vocab, seed=0)
    rit = ref_batches(RefDataConfig(**dkw))
    it = synthetic_batches(DataConfig(**dkw))
    compiled = None
    gaps, losses = [], []
    for _ in range(CURVE_STEPS):
        rb = {k: jnp.asarray(v) for k, v in next(rit).items()}
        b = {k: torch.from_numpy(v) for k, v in next(it).items()}
        if compiled is None:
            compiled = jax.jit(rstep).lower(rstate, rb).compile(
                compiler_options=XLA_NO_FMA)
        rstate, rm = compiled(rstate, rb)
        state, m = step(state, b)
        gaps.append(abs(float(m["loss"]) - float(rm["loss"])))
        losses.append(float(rm["loss"]))
        assert float(m["lr"]) == float(rm["lr"])
    assert max(gaps) <= CURVE_TOL, gaps
    assert losses[-1] < losses[0] - 0.2            # the curve fell


def test_trainer_resumes_from_its_checkpoints(tmp_path):
    cfg = smoke_config(ARCHS["qwen2.5-3b"])
    hp = TrainHParams(peak_lr=1e-3, warmup=1, total_steps=6)

    def trainer():
        tr = Trainer(cfg, hp, ckpt_dir=str(tmp_path), ckpt_every=2,
                     device="cpu")
        tr.hp_global_batch, tr.hp_seq_len = 4, 16
        return tr

    s4, log4 = trainer().fit(4)
    s6, log6 = trainer().fit(6)
    assert len(log4) == 4 and len(log6) == 2      # resumed at step 4
    assert [int(m["step"]) for m in log6] == [5, 6]
    _, again = trainer().fit(6)
    assert again == []                             # nothing to do
    straight = Trainer(cfg, hp, ckpt_dir=str(tmp_path / "straight"),
                       ckpt_every=0, device="cpu")
    straight.hp_global_batch, straight.hp_seq_len = 4, 16
    s_straight, _ = straight.fit(6)
    for a, b in zip(jax.tree.leaves(s6), jax.tree.leaves(s_straight)):
        assert torch.equal(a, b)


def test_trainer_refuses_a_mesh_and_defaults_to_the_card(tmp_path):
    cfg = smoke_config(ARCHS["qwen2.5-3b"])
    # sharded training is ported: a mesh must be a named DeviceMesh
    with pytest.raises(TypeError, match="DeviceMesh"):
        Trainer(cfg, TrainHParams(), mesh=object(), ckpt_dir=str(tmp_path))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Trainer(cfg, TrainHParams(), ckpt_dir=str(tmp_path))
