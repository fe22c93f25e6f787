"""The port's checkpoints (``repro_torch.train.checkpoint``) in the
reference's on-disk format: a round trip, cross-restores in both
directions bit for bit (bfloat16 parameters, float32 moments, the int32
step count), the same manifest, atomic publish and keep-last-k.  The
reference's side reads bfloat16 through ``ml_dtypes``; the port's needs no
``ml_dtypes``."""
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.models.layers import init_params as ref_init_params
from repro.train import checkpoint as ref_ckpt
from repro.train.train_step import TrainHParams as RefHParams
from repro.train.train_step import init_train_state as ref_init_train_state
from repro_torch.configs import ARCHS, smoke_config
from repro_torch.models.convert import train_state_from_numpy
from repro_torch.models.layers import init_params, map_tree
from repro_torch.train.checkpoint import (CheckpointManager, latest_step,
                                          restore, save)
from repro_torch.train.train_step import TrainHParams, init_train_state
from repro_torch.tree import leaf_paths, leaves
from repro_torch.zoo import get_api

from _torch_model_cases import configs, f32, ref_get_api, to_numpy_tree


def _bits(a):
    """Float leaves (bfloat16 widened exactly) as float32 bit patterns;
    integer leaves as they are."""
    a = a.numpy() if torch.is_tensor(a) and not a.is_floating_point() \
        else np.asarray(a) if not torch.is_tensor(a) and \
        np.asarray(a).dtype.kind == "i" else f32(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def _meta(tree):
    return map_tree(lambda a: torch.empty_like(a, device="meta"), tree)


def test_checkpoint_roundtrip(tmp_path):
    cfg = smoke_config(ARCHS["starcoder2-3b"])
    api = get_api(cfg)
    hp = TrainHParams(total_steps=10, warmup=1)
    params = init_params(api.param_specs(cfg),
                         torch.Generator().manual_seed(0))
    state = init_train_state(params, hp)
    save(str(tmp_path), 7, state)
    assert latest_step(str(tmp_path)) == 7
    back = restore(str(tmp_path), 7, _meta(state), device="cpu")
    for (pa, a), (pb, b) in zip(leaf_paths(state), leaf_paths(back)):
        assert pa == pb and a.dtype == b.dtype and b.device.type == "cpu"
        assert torch.equal(a, b)


def _ref_state(arch="qwen2.5-3b"):
    rcfg, _ = configs(arch)
    rp = ref_init_params(ref_get_api(rcfg).param_specs(rcfg),
                         jax.random.PRNGKey(0))
    st = ref_init_train_state(rp, RefHParams())
    # non-zero moments and count, so every leaf carries bits
    st["opt"]["m"] = jax.tree.map(lambda p: (p * 0.5).astype("float32"),
                                  st["params"])
    st["opt"]["v"] = jax.tree.map(lambda p: (p * p).astype("float32"),
                                  st["params"])
    st["opt"]["count"] = st["opt"]["count"] + 41
    return st


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    rstate = _ref_state()
    ref_ckpt.save(str(tmp_path), 41, rstate)
    like = _meta(train_state_from_numpy(to_numpy_tree(rstate), "cpu"))
    back = restore(str(tmp_path), 41, like, device="cpu")
    assert [p for p, _ in leaf_paths(back)] == \
        [p for p, _ in leaf_paths(like)]
    n_bf16 = 0
    for a, b in zip(leaves(back), jax.tree.leaves(rstate)):
        assert str(a.dtype).split(".")[1] == str(b.dtype)
        assert np.array_equal(_bits(a), _bits(b))
        n_bf16 += a.dtype == torch.bfloat16
    assert n_bf16 > 0 and back["opt"]["count"].dtype == torch.int32
    assert int(back["opt"]["count"]) == 41


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    rstate = _ref_state("starcoder2-3b")
    state = train_state_from_numpy(to_numpy_tree(rstate), "cpu")
    save(str(tmp_path / "port"), 5, state)
    ref_ckpt.save(str(tmp_path / "ref"), 5, rstate)
    back = ref_ckpt.restore(str(tmp_path / "port"), 5,
                            jax.eval_shape(lambda: rstate))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(rstate)):
        assert a.dtype == b.dtype and np.array_equal(_bits(a), _bits(b))
    # the same manifest and the same arrays in state.npz
    mans = [json.load(open(tmp_path / w / "step_5" / "manifest.json"))
            for w in ("port", "ref")]
    for key in ("step", "keys", "viewed_dtypes"):
        assert mans[0][key] == mans[1][key]
    npz = [np.load(tmp_path / w / "step_5" / "state.npz")
           for w in ("port", "ref")]
    assert sorted(npz[0].files) == sorted(npz[1].files) == mans[0]["keys"]
    for k in mans[0]["keys"]:
        assert npz[0][k].dtype == npz[1][k].dtype
        assert npz[0][k].tobytes() == npz[1][k].tobytes()


def test_atomic_publish(tmp_path):
    d = str(tmp_path)
    state = {"w": torch.arange(6, dtype=torch.float32), "n": torch.tensor(3)}
    save(d, 2, state)
    # a preempted save: a temp directory without a published step
    os.makedirs(os.path.join(d, ".tmp_step_9_123"))
    open(os.path.join(d, ".tmp_step_9_123", "state.npz"), "w").close()
    os.makedirs(os.path.join(d, "step_8"))     # no manifest: not complete
    assert latest_step(d) == 2
    assert not any(n.startswith(".tmp_step_2") for n in os.listdir(d))
    state["w"] = state["w"] + 1
    save(d, 2, state)                           # republish replaces it
    back = restore(d, 2, _meta(state), device="cpu")
    assert torch.equal(back["w"], state["w"])
    assert latest_step(str(tmp_path / "missing")) is None


def test_keep_last_k_and_async_saves(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, every=2)
    state = {"w": torch.zeros(4)}
    saved = [s for s in range(1, 8) if mgr.maybe_save(s, state)]
    assert mgr.maybe_save(7, state, force=True)
    mgr.wait()
    assert saved == [2, 4, 6]
    steps = sorted(int(n.split("_")[1]) for n in os.listdir(tmp_path)
                   if n.startswith("step_"))
    assert steps[-2:] == [6, 7] and len(steps) <= 3
    assert latest_step(str(tmp_path)) == 7
    assert not CheckpointManager(str(tmp_path), every=0).maybe_save(2, state)


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_restore_defaults_to_the_card(tmp_path):
    save(str(tmp_path), 1, {"w": torch.zeros(2)})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        restore(str(tmp_path), 1, {"w": torch.zeros(2)})
