"""Train step: loss, grad (with optional microbatch accumulation), AdamW.

Counterpart of ``repro/train/train_step.py``.  The reference's step is a
pure function compiled with the state donated; here the step runs
eagerly and donates by hand: AdamW writes each new leaf into the state's
trees as soon as it is computed (:func:`repro_torch.optim.adamw.adamw_update`
updates in place), so one model's parameters and moments exist once, not
twice.  Gradient accumulation is a Python loop over microbatches.  The
``grad_transform`` hook (identity by default) is where gradient compression
goes (see :mod:`repro_torch.optim.grad_compress`).

Gradients come from ``torch.autograd.grad`` over every parameter leaf with
``materialize_grads=True``: a leaf the loss does not reach gets zeros, as
the reference's gradient gives (the VLM's projector without patches).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch

from ..models.layers import map_tree, shard
from ..optim.adamw import AdamWConfig, adamw_update, init_opt_state
from ..optim.schedule import warmup_cosine
from ..tree import get_leaf, leaf_paths, set_leaf

__all__ = ["TrainHParams", "make_loss_fn", "make_train_step", "init_train_state"]


@dataclass(frozen=True)
class TrainHParams:
    peak_lr: float = 3e-4
    warmup: int = 200
    total_steps: int = 10000
    microbatches: int = 1
    aux_weight: float = 0.01       # MoE load-balance loss weight
    remat: bool = True             # activation checkpointing per layer
    adamw: AdamWConfig = field(default_factory=AdamWConfig)


def make_loss_fn(api, cfg, hp: TrainHParams):
    def loss_fn(params, batch):
        logits, aux = api.logits(params, batch, cfg, remat=hp.remat)
        tgt = batch["targets"].long()
        mask = batch.get("loss_mask")
        if mask is None:
            mask = torch.ones(tgt.shape, dtype=torch.float32,
                              device=tgt.device)
        lf = logits.float()
        nll = (_logsumexp(lf) - _target_logits(lf, tgt)) * mask
        denom = torch.clamp(torch.sum(mask), min=1.0)
        loss = torch.sum(nll) / denom
        total = loss + hp.aux_weight * aux
        return total, {"loss": loss, "aux": aux, "tokens": denom}

    return loss_fn


def _vocab_split(lf: torch.Tensor) -> bool:
    """Whether a mesh splits ``lf``'s last (vocab) dim over more than one
    rank."""
    vd = lf.dim() - 1
    return any(p.is_shard(vd) and lf.device_mesh.size(m) > 1
               for m, p in enumerate(getattr(lf, "placements", ())))


def _logsumexp(lf: torch.Tensor) -> torch.Tensor:
    """``logsumexp`` over the vocab (last) dim.  Where a mesh splits the
    vocab, the max and the sum of exponentials are partial results
    all-reduced over it (DTensor's ``logsumexp`` gathers the whole vocab),
    and the max is a constant of the gradient, as in ``logsumexp``'s own
    backward."""
    vd = lf.dim() - 1
    if not _vocab_split(lf):
        return torch.logsumexp(lf, dim=vd)
    m = shard(lf.detach().amax(dim=vd, keepdim=True), "batch", "seq", None)
    s = shard(torch.sum(torch.exp(lf - m), dim=vd), "batch", "seq")
    return torch.log(s) + m[..., 0]


def _target_logits(lf: torch.Tensor, tgt: torch.Tensor) -> torch.Tensor:
    """``lf[..., tgt]``: each position's logit of its target.

    On a mesh that shards the vocab dim, each rank picks the targets its
    vocab slice holds and the picks are a partial sum over those mesh dims
    (GSPMD's masked gather), so neither direction forms the whole vocab (a
    DTensor gather's backward does, over the whole batch).  Bit for bit the
    plain gather: the ranks that do not hold a target add exact zeros."""
    vd = lf.dim() - 1
    if not _vocab_split(lf):
        return shard(torch.gather(lf, vd, tgt[..., None]),
                     "batch", "seq", None)[..., 0]
    from torch.distributed.tensor import DTensor, Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    mesh, pl = lf.device_mesh, tuple(lf.placements)
    t_pl = tuple(Replicate() if p.is_shard(vd) else p for p in pl)
    o_pl = tuple(Partial() if p.is_shard(vd) else p for p in pl)
    if not hasattr(tgt, "placements"):
        tgt = DTensor.from_local(tgt, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
    tgt = tgt.redistribute(mesh, t_pl)
    # this rank's first vocab row: DTensor's chunks, over the mesh dims in order
    off, size = 0, lf.shape[vd]
    for m, c in enumerate(mesh.get_coordinate()):
        if pl[m].is_shard(vd):
            chunk = -(-size // mesh.size(m))
            off += c * chunk
            size = max(min(chunk, size - c * chunk), 0)

    def pick(lf_loc, tgt_loc):
        n = lf_loc.shape[vd]
        idx = tgt_loc - off
        got = torch.gather(lf_loc, vd, idx.clamp(0, n - 1)[..., None])[..., 0]
        return torch.where((idx >= 0) & (idx < n), got, 0.0)

    ll = local_map(pick, out_placements=(o_pl,), in_placements=(pl, t_pl),
                   in_grad_placements=(pl, t_pl), device_mesh=mesh)(lf, tgt)
    return shard(ll, "batch", "seq")


def _adamw_config(hp: TrainHParams, moment_dtype) -> AdamWConfig:
    return AdamWConfig(moment_dtype=moment_dtype, **{
        k: getattr(hp.adamw, k)
        for k in ("b1", "b2", "eps", "weight_decay", "grad_clip")
    })


def init_train_state(params, hp: TrainHParams, moment_dtype=torch.float32):
    """``{"params", "opt"}``; the state's trees are new dicts holding the
    caller's tensors, so a donating step never rewrites the caller's own
    dicts."""
    return {"params": map_tree(lambda a: a, params),
            "opt": init_opt_state(params, _adamw_config(hp, moment_dtype))}


def _grads(loss_fn, params, batch):
    """(grads with ``params``' nesting, detached aux) of one batch."""
    paths = [path for path, _ in leaf_paths(params)]
    tree = map_tree(lambda a: a, params)
    leaves = []
    for path in paths:
        leaf = get_leaf(params, path).detach().requires_grad_()
        leaves.append(leaf)
        set_leaf(tree, path, leaf)
    total, aux = loss_fn(tree, batch)
    del tree
    gs = list(torch.autograd.grad(total, leaves, materialize_grads=True))
    del total, leaves
    grads = map_tree(lambda a: None, params)
    for i, path in enumerate(paths):
        g, gs[i] = gs[i], None
        p = get_leaf(params, path)
        if hasattr(g, "placements") and g.placements != p.placements:
            # a partial sum over the data axes reduced onto the parameter's
            # shards (GSPMD's reduce-scatter): AdamW squares sums, not parts
            g = g.redistribute(p.device_mesh, p.placements)
        set_leaf(grads, path, g)
    return grads, {k: v.detach() for k, v in aux.items()}


def _micro(x: torch.Tensor, k: int, i: int) -> torch.Tensor:
    """Microbatch ``i`` of ``k``: rows ``[i B/k, (i+1) B/k)`` of ``x``.

    A batch sharded over the data axes cannot be split so in place (a
    microbatch's rows live on a part of the ranks): the token batch is
    gathered, split, and the microbatch placed over the data axes again,
    as the reference's step constrains it."""
    if not hasattr(x, "placements"):
        return x.reshape(k, x.shape[0] // k, *x.shape[1:])[i]
    from torch.distributed.tensor import Replicate

    whole = x.redistribute(x.device_mesh, [Replicate()] * x.device_mesh.ndim)
    mb = whole.reshape(k, x.shape[0] // k, *x.shape[1:])[i]
    return shard(mb, "batch", *([None] * (mb.dim() - 1)))


def make_train_step(api, cfg, hp: TrainHParams, moment_dtype=torch.float32,
                    grad_transform=None, accum_dtype=None):
    """Returns train_step(state, batch) -> (state, metrics).

    The step donates ``state``: its trees are updated in place and the same
    dict is returned, so the caller's references to the old leaves are the
    only ones left (the reference's ``donate_argnums=0``).  ``batch`` holds
    tensors on the parameters' device.  ``grad_transform(grads) -> grads``
    is the hook where gradient compression is inserted (identity by
    default).
    """
    loss_fn = make_loss_fn(api, cfg, hp)
    ocfg = _adamw_config(hp, moment_dtype)
    acc_dt = accum_dtype or moment_dtype

    def compute_grads(params, batch):
        if hp.microbatches <= 1:
            return _grads(loss_fn, params, batch)
        k = hp.microbatches
        # zeros_like: a DTensor leaf's accumulator takes its placements
        acc = map_tree(lambda p: torch.zeros_like(p, dtype=acc_dt), params)
        for i in range(k):
            mb = {key: _micro(x, k, i) for key, x in batch.items()}
            g, aux = _grads(loss_fn, params, mb)
            for path, a in leaf_paths(acc):
                a.add_(get_leaf(g, path).to(acc_dt))
            del g
        inv = 1.0 / k
        return map_tree(lambda g: g * inv, acc), aux

    def train_step(state, batch):
        grads, aux = compute_grads(state["params"], batch)
        if grad_transform is not None:
            grads = grad_transform(grads)
        step = state["opt"]["count"]
        lr = warmup_cosine(step, hp.peak_lr, hp.warmup, hp.total_steps)
        state["params"], state["opt"], om = adamw_update(
            state["params"], grads, state["opt"], lr, ocfg)
        metrics = {**aux, **om, "step": step + 1}
        return state, metrics

    return train_step
