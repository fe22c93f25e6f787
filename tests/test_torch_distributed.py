"""The port's distribution layer on multiple ranks, against the reference's
own sharded results.

The port's ranks run on the CPU over gloo (``_torch_dist_ranks``: spawned
processes joined through a ``FileStore``, each group with its own timeout).
The reference runs in a subprocess with 8 XLA host devices.  Its tests build
their meshes with ``jax.make_mesh``, whose axes are *Explicit* on the
installed jax and which then cannot run their step (ROADMAP C27); here the
same meshes are built as ``jax.sharding.Mesh`` over the devices (Auto axes),
in the subprocess's own code, so nothing of the reference changes.

  * qwen2.5-3b smoke at 4x2 (``microbatches=2``, the reference's
    ``PRNGKey(0)`` parameters carried over, tokens from ``PRNGKey(1)``): in
    bfloat16 its two steps within ``LOSS_TOL`` of the reference's 4x2 losses
    and of the port's own ``mesh=None`` run (a tolerance: ``grad_norm`` sums
    each leaf's squares per rank, then across ranks), a third finite; in
    float32 three steps within ``F32_TOL`` (the first step's learning rate
    is 0: the third is the first to show an update);
  * qwen2.5-3b (2 KV heads) and rwkv6-3b (the token-shift LoRA's 5) smoke
    on 1x4, where the model axis divides neither: every step finite and
    within ``LOSS_TOL`` of ``mesh=None`` (rwkv6-3b: the first, C29);
  * rwkv6-3b at 6 heads, zamba2-7b, and qwen2.5-3b at 6 query heads and
    2 KV heads (its blockwise attention) smoke on 1x4 in float32, the
    recurrence or the attention in blocks of heads (4 ranks, 2 blocks of
    rwkv6's and qwen's heads, C30):
    three steps within ``LOSS_TOL`` of ``mesh=None`` and their gradient
    norms within ``SPLIT_GRAD_TOL``;
  * deepseek-moe-16b smoke on 2x2: the first step's loss within
    ``LOSS_TOL`` of ``mesh=None`` in bfloat16 (S 16), and in float32 at S 80
    (the blockwise attention, heads over the model axis) the same routes and
    three steps within ``F32_TOL`` (bfloat16 flips routes there, C28);
  * ``make_crosspod_psum`` on a (2, 4) ``(pod, data)`` mesh: bit-equal to
    the reference's ``shard_map`` output, within 2 % of the mean;
  * elastic restore onto (2, 2): the port's checkpoint written from (4, 2)
    and the reference's, restored by the port, and the port's restored by
    the reference -- all bit-equal;
  * a mesh of one rank: three ``Trainer.fit`` steps at S 96 (the blockwise
    attention) bit-equal to ``mesh=None`` (loss, grad norm, every leaf).
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, smoke_config
from repro_torch.train.train_step import TrainHParams
from repro_torch.train.trainer import Trainer

import _torch_dist_ranks
from _torch_dist_ranks import spawn

ROOT = Path(__file__).resolve().parents[1]
LOSS_TOL = 2e-3         # tests/test_torch_train_step.py
#: a float32 gradient norm on the 1x4 mesh against one rank, relative: the
#: reduction order alone (4e-5 at rwkv6's third step, counted on a CPU)
SPLIT_GRAD_TOL = 1e-3
#: float32 sharded vs unsharded: the reduction order only (measured: 1.4e-6
#: over four steps of the 4x2 case)
F32_TOL = 1e-5
#: each process group's (and each reference subprocess's) own timeout, s
GROUP_TIMEOUT = 240

_REF_WRITE = r"""
import json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.configs import ARCHS, smoke_config
from repro.distributed.sharding import act_rules, state_shardings
from repro.models.layers import init_params, mesh_context
from repro.optim.grad_compress import ef_compress_grads, make_crosspod_psum
from repro.train.checkpoint import save
from repro.train.train_step import TrainHParams, init_train_state, make_train_step
from repro.zoo import get_api

out = sys.argv[1]
devs = np.array(jax.devices())
res = {"devices": len(devs)}

# test_train_step_executes_on_8_devices, on an Auto-axis mesh
mesh = Mesh(devs.reshape(4, 2), ("data", "model"))
cfg = smoke_config(ARCHS["qwen2.5-3b"])
api = get_api(cfg)
hp = TrainHParams(total_steps=4, warmup=1, microbatches=2)
step = make_train_step(api, cfg, hp)
rules = act_rules(mesh)

def fn(state, batch):
    with mesh_context(mesh, rules):
        return step(state, batch)

specs = api.param_specs(cfg)
p_shard = state_shardings(specs, mesh)
state_shard = {"params": p_shard, "opt": {"m": p_shard, "v": p_shard,
               "count": NamedSharding(mesh, P())}}
params = init_params(specs, jax.random.PRNGKey(0))
save(out + "/qwen", 0, params)
state = init_train_state(params, hp)
state = jax.device_put(state, state_shard)
t = jax.random.randint(jax.random.PRNGKey(1), (8, 33), 0, cfg.vocab)
np.save(out + "/tokens.npy", np.asarray(t))
batch = {"tokens": t[:, :-1], "targets": t[:, 1:],
         "loss_mask": jnp.ones((8, 32), jnp.float32)}
bshard = jax.tree.map(
    lambda x: NamedSharding(mesh, P("data", *([None]*(x.ndim-1)))), batch)
batch = jax.device_put(batch, bshard)
jitted = jax.jit(fn, in_shardings=(state_shard, bshard),
                 out_shardings=(state_shard, None), donate_argnums=0)
state, metrics = jitted(state, batch)
res["loss1"] = float(metrics["loss"])
state, metrics = jitted(state, batch)
res["loss"] = float(metrics["loss"])

# test_crosspod_compressed_psum, on an Auto-axis mesh
pods = Mesh(devs.reshape(2, 4), ("pod", "data"))
crosspod = make_crosspod_psum(pods)
g_global = jnp.asarray(
    np.random.default_rng(0).normal(0, 1, (2, 64)), jnp.float32)
np.save(out + "/g_global.npy", np.asarray(g_global))

def per_pod(g):
    q, s, e = ef_compress_grads({"g": g[0]}, {"g": jnp.zeros_like(g[0])})
    return crosspod(q, s)["g"][None]

shard_map = getattr(jax, "shard_map", None)
if shard_map is None:
    from jax.experimental.shard_map import shard_map
f = shard_map(per_pod, mesh=pods, in_specs=P("pod", None),
              out_specs=P("pod", None))
got = np.asarray(f(g_global))
res["crosspod"] = got[0].tolist()
res["crosspod_pods_agree"] = bool(np.array_equal(got[0], got[1]))

# test_elastic_checkpoint_across_mesh_sizes: the (4, 2) save
sc = smoke_config(ARCHS["starcoder2-3b"])
sspecs = get_api(sc).param_specs(sc)
big = Mesh(devs.reshape(4, 2), ("data", "model"))
sp = jax.device_put(init_params(sspecs, jax.random.PRNGKey(0)),
                    state_shardings(sspecs, big))
save(out + "/ref42", 1, sp)
print(json.dumps(res))
"""

_REF_RESTORE = r"""
import json, sys
import jax, numpy as np
from jax.sharding import Mesh
from repro.configs import ARCHS, smoke_config
from repro.distributed.sharding import state_shardings
from repro.models.layers import abstract_params
from repro.train.checkpoint import restore
from repro.zoo import get_api

ckpt, whole = sys.argv[1], np.load(sys.argv[2])
sc = smoke_config(ARCHS["starcoder2-3b"])
specs = get_api(sc).param_specs(sc)
small = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
back = restore(ckpt, 1, abstract_params(specs),
               shardings=state_shardings(specs, small))
paths = jax.tree_util.tree_flatten_with_path(back)[0]
bad = []
for path, leaf in paths:
    key = "//".join(p.key for p in path)
    a = np.asarray(leaf)
    if a.dtype.itemsize == 2:
        a = a.view(np.uint16)
    if not np.array_equal(a, whole[key]):
        bad.append(key)
print(json.dumps({"n": len(paths), "bad": bad,
                  "devices": len({d for l in jax.tree.leaves(back)
                                  for d in l.devices()})}))
"""


def _ref_start(code: str, *args) -> subprocess.Popen:
    """The reference's ``code`` in a subprocess with 8 XLA host devices."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    return subprocess.Popen([sys.executable, "-c", textwrap.dedent(code),
                             *map(str, args)], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env,
                            cwd=str(ROOT))


def _ref_end(proc: subprocess.Popen) -> dict:
    """Its last line's JSON, within ``GROUP_TIMEOUT`` (killed past it)."""
    try:
        out, err = proc.communicate(timeout=GROUP_TIMEOUT)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-4000:]
    return json.loads(out.strip().splitlines()[-1])


def _ref(code: str, *args) -> dict:
    return _ref_end(_ref_start(code, *args))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's sharded runs beside the port's 4-rank group (which
    needs nothing of them), then the port's 8-rank group, then the
    reference restoring the port's checkpoint."""
    ref_dir = tmp_path_factory.mktemp("ref")
    tmp = tmp_path_factory.mktemp("port")
    ref_proc = _ref_start(_REF_WRITE, ref_dir)
    try:
        spawn("world4", 4, str(tmp), GROUP_TIMEOUT)
    finally:
        ref = _ref_end(ref_proc)
    spawn("world8", 8, str(tmp), GROUP_TIMEOUT, ref_dir=str(ref_dir),
          tmp=str(tmp))
    back = _ref(_REF_RESTORE, tmp / "port42", tmp / "port42_whole.npz")
    return dict(ref=ref, ref_dir=ref_dir, tmp=tmp, back=back,
                world8=torch.load(tmp / "world8.pt"),
                world4=torch.load(tmp / "world4.pt"))


@pytest.fixture
def restore_dtypes(monkeypatch):
    """A float32 run sets the model modules' ``DTYPE``: put it back."""
    import importlib

    for name in _torch_dist_ranks.F32_MODULES:
        mod = importlib.import_module(f"repro_torch.models.{name}")
        monkeypatch.setattr(mod, "DTYPE", mod.DTYPE)


def test_4x2_train_step_matches_the_reference_4x2_loss(runs):
    """bfloat16, as the reference's test: its two steps within ``LOSS_TOL``
    of the reference's 4x2 losses and of the port's ``mesh=None`` steps
    (grad norm within 2 %); a third step finite and moved by the update."""
    ref, got = runs["ref"], runs["world8"]["mesh42"]["bfloat16"]
    assert ref["devices"] == 8
    plain = _torch_dist_ranks.qwen_steps("bfloat16", str(runs["ref_dir"]))
    assert len(got) == len(plain) == _torch_dist_ranks.STEPS
    assert all(np.isfinite(g["loss"]) for g in got)
    assert got[2]["loss"] != got[0]["loss"]     # the update reached step 3
    assert abs(got[0]["loss"] - ref["loss1"]) < LOSS_TOL
    assert abs(got[1]["loss"] - ref["loss"]) < LOSS_TOL, (got, ref)
    for g, p in zip(got[:2], plain):
        assert abs(g["loss"] - p["loss"]) < LOSS_TOL, (got, plain)
        assert abs(g["grad_norm"] - p["grad_norm"]) < 0.02 * p["grad_norm"]


def test_4x2_updates_match_unsharded_in_float32(runs, restore_dtypes):
    """float32, where the sharded sums differ from one rank's only in
    order: every step within ``F32_TOL``, the updates made from sharded
    gradients included."""
    got = runs["world8"]["mesh42"]["float32"]
    plain = _torch_dist_ranks.qwen_steps("float32", str(runs["ref_dir"]))
    assert got[2]["loss"] != got[0]["loss"]
    for g, p in zip(got, plain):
        assert abs(g["loss"] - p["loss"]) < F32_TOL, (got, plain)
        assert abs(g["grad_norm"] - p["grad_norm"]) < F32_TOL * p[
            "grad_norm"], (got, plain)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_expert_axis_on_2x2_matches_unsharded(runs, restore_dtypes, dtype):
    """In bfloat16 (S 16) the first step within ``LOSS_TOL``, every step
    finite and the third moved; in float32 (S 80: the blockwise attention
    with heads over the model axis) the same routes -- aux equal -- and
    every step within ``F32_TOL``.  At S 80 bfloat16 flips routes (ROADMAP
    C28)."""
    want = _torch_dist_ranks.moe_steps(dtype)
    got = runs["world4"]["moe22"][dtype]
    assert all(np.isfinite(g["loss"]) for g in got)
    assert got[2]["loss"] != got[0]["loss"]     # the update reached step 3
    if dtype == "bfloat16":
        assert abs(got[0]["loss"] - want[0]["loss"]) < LOSS_TOL, (got, want)
        return
    assert got[0]["aux"] == want[0]["aux"], (got, want)
    for g, w in zip(got, want):
        assert abs(g["loss"] - w["loss"]) < F32_TOL, (got, want)
        assert abs(g["grad_norm"] - w["grad_norm"]) < F32_TOL * w[
            "grad_norm"], (got, want)


def test_crosspod_psum_bit_equal_to_the_reference_shard_map(runs):
    ref, got = runs["ref"], runs["world8"]
    assert ref["crosspod_pods_agree"]
    want = np.asarray(ref["crosspod"], dtype=np.float32)
    out = np.asarray(got["crosspod"], dtype=np.float32)
    assert np.array_equal(out.view(np.uint32), want.view(np.uint32))
    mean = np.load(runs["ref_dir"] / "g_global.npy").mean(axis=0)
    assert np.max(np.abs(out - mean)) / np.max(np.abs(mean)) < 0.02
    assert got["crosspod_none"]          # no pod axis: None


@pytest.mark.parametrize("name", ["port42", "ref42"])
def test_elastic_restore_onto_2x2_is_bit_equal(runs, name):
    """A checkpoint written from a (4, 2) mesh -- by the port or by the
    reference -- restored by the port's ``elastic_restore`` onto (2, 2)."""
    got = np.load(runs["tmp"] / f"{name}_on22.npz")
    if name == "port42":
        want = np.load(runs["tmp"] / "port42_whole.npz")
    else:
        want = np.load(runs["ref_dir"] / "ref42" / "step_1" / "state.npz")
    assert sorted(got.files) == sorted(want.files)
    for k in want.files:
        assert np.array_equal(got[k], want[k]), k
    # placed on the new mesh by the rules, not replicated everywhere
    placements = runs["world8"][f"{name}_placements"]
    assert any("Shard" in p for p in placements), placements
    assert runs["world8"][f"{name}_mesh"] == [2, 2]


def test_reference_restores_the_port_checkpoint_onto_2x2(runs):
    back = runs["back"]
    assert back["n"] > 0 and back["bad"] == []
    assert back["devices"] == 4


@pytest.mark.parametrize("arch,bs", _torch_dist_ranks.UNEVEN_CASES)
def test_1x4_heads_the_model_axis_does_not_divide(runs, arch, bs):
    """A head or LoRA dim the model axis does not divide (DTensor cannot
    unflatten an uneven shard; ROADMAP C29): on the 1x4 mesh every step
    finite, the third moved, and the steps within ``LOSS_TOL`` of
    ``mesh=None`` -- qwen2.5-3b's three, rwkv6-3b's first.  The smoke
    rwkv6-3b is ill-conditioned at depth 4: a 1e-7 relative change of its
    float32 parameters moves its gradients by 4e-4, so its updates part
    from ``mesh=None`` by the reduction order alone."""
    res = runs["world4"]["uneven"][f"{arch}/{bs}"]
    assert len(res["mesh"]) == len(res["plain"]) == _torch_dist_ranks.STEPS
    assert all(np.isfinite(g["loss"]) for g in res["mesh"])
    assert res["mesh"][2]["loss"] != res["mesh"][0]["loss"]
    n = _torch_dist_ranks.STEPS if arch == "qwen2.5-3b" else 1
    for g, p in zip(res["mesh"][:n], res["plain"][:n]):
        assert abs(g["loss"] - p["loss"]) < LOSS_TOL, res


@pytest.mark.parametrize("arch", [c[0] for c in _torch_dist_ranks.SPLIT_CASES])
def test_1x4_recurrence_in_blocks_of_heads(runs, arch):
    """The recurrence, or the blockwise attention, run in blocks of heads
    on each rank (``local_call``'s GSPMD split: rwkv6's 6 heads in 2 blocks
    over 4 ranks, each output summed from its block's first replica;
    zamba2's 8 in 4; qwen's 6 query heads in 2 blocks of 3, each beside its
    KV head), in float32:
    every step within ``LOSS_TOL`` of ``mesh=None``, and its gradient norm
    within ``SPLIT_GRAD_TOL`` relatively (a block counted twice, or not at
    all, moves it by that block's share).  In bfloat16 the smoke rwkv6-3b
    at 6 heads parts from ``mesh=None`` by 7 % in its first gradient norm
    with its heads whole on every rank or split, bit for bit the same: the
    rounding of the rest of the sharded step, not the split."""
    res = runs["world4"]["split"][arch]
    assert len(res["mesh"]) == len(res["plain"]) == _torch_dist_ranks.STEPS
    for g, p in zip(res["mesh"], res["plain"]):
        assert np.isfinite(g["loss"]) and np.isfinite(g["grad_norm"])
        assert abs(g["loss"] - p["loss"]) < LOSS_TOL, res
        assert abs(g["grad_norm"] - p["grad_norm"]) < SPLIT_GRAD_TOL * abs(
            p["grad_norm"]), res
    assert res["mesh"][2]["loss"] != res["mesh"][0]["loss"]


def test_mesh_of_one_rank_is_bit_equal_to_no_mesh(tmp_path):
    from torch.distributed.tensor import DTensor

    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.tree import leaf_paths

    cfg = smoke_config(ARCHS["qwen2.5-3b"])
    hp = TrainHParams(total_steps=4, warmup=1)

    def fit(mesh, d):
        tr = Trainer(cfg, hp, mesh=mesh, ckpt_dir=str(tmp_path / d),
                     ckpt_every=0, device="cpu" if mesh is None else None)
        # S 96 > attn_block_kv 64: the blockwise attention and its backward
        tr.hp_global_batch, tr.hp_seq_len = 4, 96
        return tr.fit(3)

    plain, plain_log = fit(None, "plain")
    import torch.distributed as dist
    assert not dist.is_initialized()
    try:
        mesh = make_local_mesh(device="cpu")    # starts a group of one
        assert dist.get_world_size() == 1
        assert mesh.mesh_dim_names == ("data", "model")
        sharded, log = fit(mesh, "mesh")
    finally:
        dist.destroy_process_group()
    assert len(log) == len(plain_log) == 3
    for a, b in zip(plain_log, log):
        for k in ("loss", "grad_norm", "aux", "lr"):
            assert torch.equal(a[k], b[k]), k
    for (p, a), (q, b) in zip(leaf_paths(plain), leaf_paths(sharded)):
        assert p == q
        assert isinstance(b, DTensor), p
        assert torch.equal(a, b.full_tensor()), p
