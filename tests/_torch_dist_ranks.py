"""Multi-rank jobs of the port's distribution tests, run on the CPU over
gloo: ``spawn`` starts ``world`` ranks of a job with
``torch.multiprocessing`` (spawned, never forked), joined through a
``FileStore`` (no TCP port, so test workers never race for one), and fails
the calling test when a rank raises or the group outlives its timeout.

This module imports torch and the port only: each spawned rank imports it,
and neither jax nor the reference belongs there.  A job writes what the
test reads into ``out`` (a directory) from rank 0.
"""
import os
import time

import numpy as np
import torch


def _entry(rank, world, store, job, out, kw):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        JOBS[job](rank, out, **kw)
    finally:
        dist.destroy_process_group()


def spawn(job: str, world: int, out: str, timeout: float, **kw) -> None:
    """Run ``JOBS[job]`` on ``world`` gloo ranks; raise if a rank fails or
    the group is not done within ``timeout`` seconds (every rank is then
    killed)."""
    import torch.multiprocessing as mp

    os.makedirs(out, exist_ok=True)
    store = os.path.join(out, f"store_{job}")
    ctx = mp.start_processes(_entry, args=(world, store, job, out, kw),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{job} on {world} ranks outlived its "
                                   f"{timeout} s timeout")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()


#: deepseek-moe-16b's (batch, seq) on the 2x2 mesh: in bfloat16 at S 16;
#: in float32 at S 80 (> the smoke config's attn_block_kv 64: the blockwise
#: attention, heads over the model axis), where bfloat16 flips routes
#: (ROADMAP C28)
MOE_BS = {"bfloat16": (4, 16), "float32": (4, 80)}
#: the model modules whose ``DTYPE`` a float32 run sets
F32_MODULES = ("layers", "transformer", "moe", "rwkv6", "mamba2", "hybrid")
#: steps of a multi-rank run: the first step's learning rate is 0, so the
#: third is the first to show an update made from sharded gradients
STEPS = 3


def _steps(cfg, hp, params, batch, dtype, mesh, keys=("loss", "grad_norm")):
    """``STEPS`` steps from ``params`` on ``batch`` through
    ``Trainer(mesh=mesh)`` (the CPU without one).  A float32 run sets the
    model modules' ``DTYPE`` (callers restore it) and casts the
    parameters."""
    import importlib

    from repro_torch.distributed.sharding import place_
    from repro_torch.models.layers import map_tree
    from repro_torch.train.train_step import init_train_state
    from repro_torch.train.trainer import Trainer

    tr = Trainer(cfg, hp, mesh=mesh, ckpt_dir="unused",
                 device="cpu" if mesh is None else None)
    if dtype == "float32":
        for name in F32_MODULES:
            mod = importlib.import_module(f"repro_torch.models.{name}")
            mod.DTYPE = torch.float32
        params = map_tree(lambda t: t.float(), params)
    state = init_train_state(params, hp)
    if mesh is not None:
        place_(state, tr.state_shardings)
    return train_steps(tr, state, batch, STEPS, keys)[1]


def qwen_steps(dtype: str, ref_dir: str, mesh=None):
    """The reference test's 4x2 case: qwen2.5-3b smoke, ``microbatches=2``,
    the reference's ``PRNGKey(0)`` parameters and ``PRNGKey(1)`` tokens
    (written by it under ``ref_dir``)."""
    from repro_torch.configs import ARCHS, smoke_config
    from repro_torch.models.layers import abstract_params
    from repro_torch.train.checkpoint import restore
    from repro_torch.train.train_step import TrainHParams
    from repro_torch.zoo import get_api

    cfg = smoke_config(ARCHS["qwen2.5-3b"])
    hp = TrainHParams(total_steps=4, warmup=1, microbatches=2)
    params = restore(os.path.join(ref_dir, "qwen"), 0, abstract_params(
        get_api(cfg).param_specs(cfg)), device="cpu")
    tok = torch.from_numpy(np.load(os.path.join(ref_dir, "tokens.npy")))
    batch = {"tokens": tok[:, :-1], "targets": tok[:, 1:],
             "loss_mask": torch.ones(tok.shape[0], tok.shape[1] - 1)}
    return _steps(cfg, hp, params, batch, dtype, mesh)


def moe_steps(dtype: str, mesh=None):
    """deepseek-moe-16b smoke from the port's seed-0 parameters at
    ``MOE_BS[dtype]``, with the router's aux loss."""
    from repro_torch.configs import ARCHS, smoke_config
    from repro_torch.models.layers import init_params
    from repro_torch.train.train_step import TrainHParams
    from repro_torch.train.trainer import Trainer

    cfg = smoke_config(ARCHS["deepseek-moe-16b"])
    hp = TrainHParams(total_steps=4, warmup=1)
    tr = Trainer(cfg, hp, ckpt_dir="unused", device="cpu")
    tr.hp_global_batch, tr.hp_seq_len = MOE_BS[dtype]
    batch = next(tr.data_iter(0))
    params = init_params(tr.specs, torch.Generator().manual_seed(0))
    return _steps(cfg, hp, params, batch, dtype, mesh,
                  ("loss", "grad_norm", "aux"))


# -- helpers -------------------------------------------------------------------

def _bits(t: torch.Tensor) -> np.ndarray:
    """A tensor's bit pattern as a numpy array (bfloat16 as uint16)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _whole(tree) -> dict:
    """``{path: bits}`` of a tree of tensors or DTensors, gathered whole (a
    collective for DTensors)."""
    from repro_torch.distributed.sharding import full
    from repro_torch.tree import leaf_paths

    return {"//".join(map(str, p)): _bits(full(x))
            for p, x in leaf_paths(tree)}


def train_steps(tr, state, batch, n, keys=("loss", "grad_norm")):
    """``n`` steps of ``tr.train_step`` on ``batch``: (state, [{key: value}
    a step])."""
    metrics = []
    for _ in range(n):
        state, m = tr.train_step(state, dict(batch))
        metrics.append({k: float(m[k]) for k in keys})
    return state, metrics


# -- jobs ----------------------------------------------------------------------

def job_world8(rank, out, ref_dir, tmp):
    """On 8 ranks: (1) the reference test's qwen2.5-3b steps at 4x2 from
    the reference's parameters and tokens, in bfloat16 and float32; (2)
    ``make_crosspod_psum`` on a (2, 4) ``(pod, data)`` mesh; (3) starcoder2-3b's parameters saved from
    a (4, 2) mesh, with their whole values beside them; (4) that checkpoint
    and the reference's restored by ``elastic_restore`` onto (2, 2) (each
    half of the ranks a (2, 2) mesh of its own), gathered whole."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import ARCHS, smoke_config
    from repro_torch.distributed.sharding import place_, state_shardings
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.layers import abstract_params, init_params
    from repro_torch.optim.grad_compress import (ef_compress_grads,
                                                 make_crosspod_psum)
    from repro_torch.train.checkpoint import save
    from repro_torch.train.ft import elastic_restore
    from repro_torch.tree import leaves
    from repro_torch.zoo import get_api

    # (1) 4 x 2 train steps, bfloat16 then float32
    mesh = make_local_mesh(4, 2, device="cpu")
    res = {"mesh42": {dt: qwen_steps(dt, ref_dir, mesh)
                      for dt in ("bfloat16", "float32")}}

    # (2) crosspod on (pod, data) = (2, 4)
    pods = init_device_mesh("cpu", (2, 4), mesh_dim_names=("pod", "data"))
    g_global = torch.from_numpy(np.load(os.path.join(ref_dir, "g_global.npy")))
    pod = pods.get_coordinate()[0]
    g = g_global[pod]
    q, s, _ = ef_compress_grads({"g": g}, {"g": torch.zeros_like(g)})
    got = make_crosspod_psum(pods)(q, s)["g"]
    res["crosspod"] = got.numpy().tolist()
    res["crosspod_none"] = make_crosspod_psum(mesh) is None

    # (3) starcoder2-3b params saved from (4, 2)
    sc = smoke_config(ARCHS["starcoder2-3b"])
    specs = get_api(sc).param_specs(sc)
    drawn = init_params(specs, torch.Generator().manual_seed(0))
    whole = _whole(drawn)
    save(os.path.join(tmp, "port42"), 1,
         place_(drawn, state_shardings(specs, mesh)))
    if rank == 0:
        np.savez(os.path.join(tmp, "port42_whole.npz"), **whole)

    # (4) elastic restore onto (2, 2)
    small = init_device_mesh("cpu", (2, 2, 2), mesh_dim_names=(
        "half", "data", "model"))["data", "model"]
    like = abstract_params(specs)
    for name, base in (("port42", tmp), ("ref42", ref_dir)):
        back = elastic_restore(os.path.join(base, name), 1, like, small,
                               specs)
        placements = sorted({str(leaf.placements) for leaf in leaves(back)})
        whole = _whole(back)
        if rank == 0:
            np.savez(os.path.join(tmp, f"{name}_on22.npz"), **whole)
            res[f"{name}_placements"] = placements
            res[f"{name}_mesh"] = list(small.mesh.shape)
    if rank == 0:
        torch.save(res, os.path.join(out, "world8.pt"))


def job_world4(rank, out):
    """On 4 ranks: a (2, 2) mesh, deepseek-moe-16b's steps from the port's
    own seed-0 parameters, in bfloat16 and in float32; then a (1, 4) mesh,
    each ``UNEVEN_CASES`` case's steps on it and (rank 0) with
    ``mesh=None``."""
    from repro_torch.launch.mesh import make_local_mesh

    import importlib

    mods = [importlib.import_module(f"repro_torch.models.{name}")
            for name in F32_MODULES]
    dtypes = [m.DTYPE for m in mods]
    mesh = make_local_mesh(2, 2, device="cpu")
    res = {"moe22": {dt: moe_steps(dt, mesh)
                     for dt in ("bfloat16", "float32")}, "uneven": {}}
    for m, dt in zip(mods, dtypes):     # the float32 run set them
        m.DTYPE = dt
    mesh = make_local_mesh(1, 4, device="cpu")
    for arch, bs in UNEVEN_CASES:
        got = uneven_steps(arch, bs, mesh)
        if rank == 0:
            res["uneven"][f"{arch}/{bs}"] = {
                "mesh": got, "plain": uneven_steps(arch, bs)}
    res["split"] = {}
    for arch, bs, over in SPLIT_CASES:
        got = uneven_steps(arch, bs, mesh, over, "float32")
        if rank == 0:
            res["split"][arch] = {"mesh": got, "plain": uneven_steps(
                arch, bs, None, over, "float32")}
        for m, dt in zip(mods, dtypes):
            m.DTYPE = dt
    if rank == 0:
        torch.save(res, os.path.join(out, "world4.pt"))


#: the 1x4 cases: (arch, (batch, seq)); qwen2.5-3b's 4 query heads over
#: a model axis of 4 leave its 2 KV heads unsplittable (S 64: the dense
#: attention), and rwkv6-3b's token-shift LoRA reshape (B, S, 5, 32) meets
#: a flat 160 over 4 ranks
UNEVEN_CASES = (("qwen2.5-3b", (8, 64)), ("rwkv6-3b", (8, 64)))
#: the 1x4 cases whose recurrence runs in blocks of heads on each rank, in
#: float32: (arch, (batch, seq), config overrides); rwkv6-3b at 6 heads of
#: 32 (a model axis of 4 splits them into 2 blocks of 3, each on two ranks)
#: and two layers; zamba2-7b's two Mamba-2 layers (8 heads, 2 a rank, its
#: in_proj output split 4 ways); qwen2.5-3b's blockwise attention (S 128
#: over blocks of 64) at 6 query heads and 2 KV heads, two layers: 2
#: blocks of 3 query heads beside their KV head, each on two ranks
SPLIT_CASES = (("rwkv6-3b", (8, 64), {"d_model": 192, "n_layers": 2}),
               ("zamba2-7b", (8, 64), {"n_layers": 2}),
               ("qwen2.5-3b", (8, 128), {"n_heads": 6, "n_kv_heads": 2,
                                         "n_layers": 2}))


def uneven_steps(arch: str, bs: tuple, mesh=None, over=None,
                 dtype="bfloat16"):
    """The smoke ``arch``'s steps (its config with ``over`` replaced) from
    the port's seed-0 parameters on the seed-0 synthetic batch of ``bs``
    (batch, seq), in ``dtype``."""
    from repro_torch.configs import ARCHS, smoke_config
    from repro_torch.models.layers import init_params
    from repro_torch.train.train_step import TrainHParams
    from repro_torch.train.trainer import Trainer

    cfg = smoke_config(ARCHS[arch]).replace(**(over or {}))
    hp = TrainHParams(total_steps=4, warmup=1)
    tr = Trainer(cfg, hp, ckpt_dir="unused", device="cpu")
    tr.hp_global_batch, tr.hp_seq_len = bs
    batch = next(tr.data_iter(0))
    params = init_params(tr.specs, torch.Generator().manual_seed(0))
    return _steps(cfg, hp, params, batch, dtype, mesh)


JOBS = {"world8": job_world8, "world4": job_world4}
