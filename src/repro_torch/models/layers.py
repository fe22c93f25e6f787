"""Shared building blocks of the port's model stack, in plain PyTorch.

Counterpart of ``repro/models/layers.py`` for the model stack: parameter
specs and their initialisation, the norms, rotary embeddings, the MLP,
prefill attention (one dense block, or the blockwise online-softmax forward
for long sequences) and single-token attention over a contiguous cache.

Conventions
-----------
* Parameters are nested dicts of tensors; each model's ``param_specs(cfg)``
  returns the same nesting of :class:`ParamSpec`, with the reference's shapes
  and logical axis names, so a reference parameter tree carries over leaf for
  leaf (:mod:`repro_torch.models.convert`).
* Every function keeps the reference's operation order and float32 upcasts;
  with the same parameters the two packages differ only by the order in which
  sums are rounded.
* The layer stack is a Python loop over the leading ``layers`` axis (PyTorch
  runs eagerly; nothing is scanned).

Blockwise attention has the reference's custom backward (``_FlashFn``, the
counterpart of its custom-VJP ``_flash``): only ``out`` and the
float32 log-sum-exp are kept for it, and each KV block is recomputed.

Every tensor dimension carries a *logical axis name*; the distribution
layer (:mod:`repro_torch.distributed.sharding`) maps logical names to mesh
axes.  ``shard(x, *names)`` redistributes a DTensor to the rule's placements
when a mesh context is active (the reference's ``with_sharding_constraint``)
and is the identity otherwise, so the same model code runs on one device and
on a mesh.  ``attention`` takes no ``unroll``: it only shaped the
reference's scanned loop.
"""
from __future__ import annotations

import math
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

__all__ = [
    "ParamSpec",
    "init_params",
    "abstract_params",
    "param_shardings",
    "mesh_context",
    "logical_to_pspec",
    "shard",
    "local_call",
    "split_dim",
    "merge_dims",
    "reduce_proj",
    "write_slot",
    "map_tree",
    "take_layer",
    "layer_views",
    "embed",
    "rms_norm",
    "layer_norm",
    "rope",
    "attention",
    "decode_attention",
    "mlp",
    "remat_call",
    "DTYPE",
]

DTYPE = torch.bfloat16


@dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]          # logical axis names per dim
    dtype: Any = DTYPE
    init: str = "fan_in"                  # fan_in | zeros | ones | embed

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def _init_one(spec: ParamSpec, gen: torch.Generator) -> torch.Tensor:
    dev = gen.device
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=spec.dtype, device=dev)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=spec.dtype, device=dev)
    if spec.init == "embed":
        # 1/sqrt(d) keeps tied-head logits O(1) at init (CE ~ ln V)
        scale = 1.0 / math.sqrt(max(spec.shape[-1], 1))
    else:  # fan_in: scale by the penultimate (input) dimension
        fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
        scale = 1.0 / math.sqrt(max(fan_in, 1))
    # scaled in place: a leaf's peak is one float32 draw beside its result
    # (deepseek-moe-16b's experts.wi_gate is 20.7 GB of float32)
    draw = torch.randn(spec.shape, generator=gen, dtype=torch.float32,
                       device=dev)
    return draw.mul_(scale).to(spec.dtype)


def init_params(specs, generator: torch.Generator) -> dict:
    """Materialize a ParamSpec tree into tensors on ``generator.device``.

    Leaves are drawn one after another from ``generator`` in sorted-key
    order.  The draws are not the reference's (its keys are threefry); carry
    a reference tree over with :func:`repro_torch.models.convert.params_from_numpy`
    when the same numbers are needed.
    """
    if isinstance(specs, ParamSpec):
        return _init_one(specs, generator)
    return {k: init_params(specs[k], generator) for k in sorted(specs)}


def abstract_params(specs) -> dict:
    """``meta`` tensor tree for a ParamSpec tree: shapes and dtypes only,
    nothing allocated."""
    return map_tree(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                          device="meta"), specs)


# ---------------------------------------------------------------------------
# Mesh context: logical-axis -> spec resolution
# ---------------------------------------------------------------------------

_MESH_CTX: list[tuple[Any, dict[str, Any]]] = []


@contextmanager
def mesh_context(mesh, rules: dict[str, Any]):
    """Activate logical->mesh axis rules for ``shard`` / ``param_shardings``.

    ``rules`` maps a logical axis name to a mesh axis name, a tuple of mesh
    axis names, or None (replicated).  A plain tensor meeting a DTensor
    counts as replicated (positions, masks), as every array the reference
    does not constrain is under GSPMD.
    """
    from torch.distributed.tensor.experimental import implicit_replication

    _MESH_CTX.append((mesh, rules))
    try:
        with implicit_replication():
            yield
    finally:
        _MESH_CTX.pop()


def logical_to_pspec(axes: tuple[str | None, ...], rules: dict[str, Any]) -> tuple:
    """The spec (a PartitionSpec's tuple of entries) of logical ``axes``."""
    return tuple(rules.get(a) if a is not None else None for a in axes)


def shard(x: torch.Tensor, *axes: str | None) -> torch.Tensor:
    """Constrain ``x``'s placement by logical axis names: a DTensor is
    redistributed to the rule's placements on the context's mesh, and so is
    its gradient (a sharding constraint binds the cotangent too, as GSPMD's
    does: a partial-sum gradient is reduced where the forward was).  The
    identity without a context or on a plain tensor."""
    if not _MESH_CTX:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    from ..distributed.sharding import placements

    mesh, rules = _MESH_CTX[-1]
    want = _even(placements(logical_to_pspec(axes, rules), mesh), x.shape,
                 mesh)
    if not (x.requires_grad and torch.is_grad_enabled()):
        return x if tuple(x.placements) == want else x.redistribute(mesh, want)
    return _Constrain.apply(x, mesh, want)


def _even(pl: tuple, shape, mesh) -> tuple:
    """``pl`` with every shard of a dim its mesh dims do not divide evenly
    replaced by ``Replicate``: DTensor's uneven shards cannot be viewed
    (24 heads over 16 ranks), where GSPMD pads them."""
    from torch.distributed.tensor import Replicate

    ext: dict[int, int] = {}
    for m, p in enumerate(pl):
        if p.is_shard():
            ext[p.dim] = ext.get(p.dim, 1) * mesh.size(m)
    return tuple(Replicate() if p.is_shard() and shape[p.dim] % ext[p.dim]
                 else p for p in pl)


def write_slot(cache: torch.Tensor, slot: torch.Tensor,
               val: torch.Tensor) -> None:
    """``cache[:, slot] = val`` in place, ``slot`` a one-element long
    tensor (the decode caches' ring slot).  Where a mesh shards dim 1 (the
    sequence-sharded decode caches) each rank writes the slot only where
    its slice holds it, through a masked copy: DTensor's ``index_copy_``
    would index the local slice with the global slot."""
    if not any(p.is_shard(1) for p in getattr(cache, "placements", ())):
        cache.index_copy_(1, slot, val)
        return
    hit = torch.arange(cache.shape[1], device=cache.device) == slot
    cache.copy_(torch.where(hit.view(1, -1, *[1] * (cache.dim() - 2)), val,
                            cache))


class _Constrain(torch.autograd.Function):
    """``shard`` on a tensor that needs a gradient: the value and the
    gradient both redistributed to ``want``; the gradient then goes back to
    the input's placements (a partial sum's as replicated), as DTensor's
    own ``redistribute`` backward does."""

    @staticmethod
    def forward(ctx, x, mesh, want):
        from torch.distributed.tensor import Replicate

        ctx.mesh, ctx.want = mesh, want
        ctx.back = tuple(Replicate() if p.is_partial() else p
                         for p in x.placements)
        return x.redistribute(mesh, want) if tuple(x.placements) != want \
            else x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        for pl in (ctx.want, ctx.back):
            if tuple(g.placements) != pl:
                g = g.redistribute(ctx.mesh, pl)
        return g, None, None


def split_dim(x: torch.Tensor, dim: int, sizes: tuple) -> torch.Tensor:
    """``x`` with dim ``dim`` split into ``sizes`` (a reshape).  A DTensor
    that shards ``dim`` over mesh dims whose extent does not divide
    ``sizes[0]`` (2 KV heads, or 24 heads, over a model axis of 16) is made
    whole along those mesh dims first: DTensor cannot unflatten an uneven
    shard, where GSPMD pads it."""
    dim %= x.dim()
    shape = (*x.shape[:dim], *sizes, *x.shape[dim + 1:])
    if hasattr(x, "placements"):
        mesh = x.device_mesh
        on = [m for m, p in enumerate(x.placements) if p.is_shard(dim)]
        if sizes[0] % math.prod(mesh.size(m) for m in on):
            from torch.distributed.tensor import Replicate

            x = x.redistribute(mesh, [Replicate() if m in on else p
                                      for m, p in enumerate(x.placements)])
        if x.requires_grad and torch.is_grad_enabled():
            return _Split.apply(x, dim, tuple(sizes))
    return x.reshape(shape)


class _Split(torch.autograd.Function):
    """:func:`split_dim`'s reshape, its gradient merged back through
    :func:`merge_dims` (DTensor's layouts may leave it unevenly sharded)."""

    @staticmethod
    def forward(ctx, x, dim, sizes):
        ctx.dim, ctx.count = dim, len(sizes)
        return x.reshape(*x.shape[:dim], *sizes, *x.shape[dim + 1:])

    @staticmethod
    def backward(ctx, g):
        return merge_dims(g, ctx.dim, ctx.count), None, None


def merge_dims(x: torch.Tensor, dim: int, count: int = 2) -> torch.Tensor:
    """``x`` with dims ``dim .. dim+count-1`` merged into one (a reshape).
    A DTensor sharded unevenly (DTensor's own layouts may be: 40 heads over
    16 ranks) is made whole along those mesh dims first, and on one that
    needs a gradient the gradient is split back through :func:`split_dim`:
    a gradient sharded over the merged dim (the heads' ``wo`` rows) cannot
    be unflattened into heads the mesh does not divide."""
    dim %= x.dim()
    if not hasattr(x, "placements"):
        return x.reshape(*x.shape[:dim], -1, *x.shape[dim + count:])
    even = _even(tuple(x.placements), x.shape, x.device_mesh)
    if even != tuple(x.placements):     # nor flatten one
        x = x.redistribute(x.device_mesh, even)
    if not (x.requires_grad and torch.is_grad_enabled()):
        return x.reshape(*x.shape[:dim], -1, *x.shape[dim + count:])
    return _Merge.apply(x, dim, tuple(x.shape[dim:dim + count]))


class _Merge(torch.autograd.Function):
    """:func:`merge_dims`' reshape, its gradient split back through
    :func:`split_dim`."""

    @staticmethod
    def forward(ctx, x, dim, sizes):
        ctx.dim, ctx.sizes = dim, sizes
        return x.reshape(*x.shape[:dim], -1, *x.shape[dim + len(sizes):])

    @staticmethod
    def backward(ctx, g):
        return split_dim(g, ctx.dim, ctx.sizes), None, None


def reduce_proj(h: torch.Tensor, w: torch.Tensor, *axes: str | None) -> torch.Tensor:
    """``h @ w`` constrained to logical ``axes``, for a projection whose
    contraction dim a mesh splits (the model-sharded heads into ``wo``):
    there each rank's partial product is taken in float32 and the partials
    are reduced in float32, then rounded once to ``h``'s dtype, as one
    device's float32 accumulation is (partials rounded to bfloat16 first
    would round twice).  Elsewhere the plain product."""
    if not any(p.is_shard(h.dim() - 1) and h.device_mesh.size(m) > 1
               for m, p in enumerate(getattr(h, "placements", ()))):
        return shard(h @ w, *axes)
    return shard(h.float() @ w.float(), *axes).to(h.dtype)


def local_call(fn, in_axes: tuple, out_axes: tuple, *args):
    """``fn(*args)`` run on each rank's own shards, for a computation DTensor
    cannot place (an op without a sharding rule) but the reference's layout
    makes shard-local.  On a mesh each tensor argument is redistributed to
    the logical axes of its entry of ``in_axes`` (``None`` for anything
    else), ``fn`` sees plain local tensors, and its outputs are DTensors
    placed by ``out_axes`` (one axes tuple per output).  An argument whole
    along a mesh dim that another argument shards gets a partial-sum
    gradient there (each rank saw a part of the other's slices: a weight's
    gradient over the data axes).  The plain call without a context or
    DTensor arguments.

    A logical axis that some argument's dim does not divide evenly over its
    mesh dims is split as GSPMD splits it: into ``g`` blocks, ``g`` the
    greatest common divisor of the axis's extent and its sizes, each block
    replicated over the remaining ``extent / g`` ranks (40 heads over 16
    ranks: 5 heads a rank, each block on two ranks; ``g`` 1 leaves the axis
    whole on every rank).  Such arguments reach the ranks whole and ``fn``
    sees its block; the outputs are whole again on every rank, summed from
    the blocks' first replicas (the others add zeros and send no gradient):
    every output must be floating and carry every axis so cut, or the call
    raises."""
    lead = next((a for a in args if hasattr(a, "placements")), None)
    if not _MESH_CTX or lead is None:
        return fn(*args)
    from torch.distributed.tensor import DTensor, Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    from ..distributed.sharding import placements

    mesh, rules = _MESH_CTX[-1]
    sizes: dict[str, set] = {}
    for a, ax in zip(args, in_axes):
        for d, n in enumerate(ax or ()):
            if n is not None:
                sizes.setdefault(n, set()).add(a.shape[d])
    # the logical axes some argument's dim cannot split evenly stay whole
    # for every argument and output, as ``shard`` leaves them; those of
    # them with a common divisor are then cut into ``blocks`` in ``fn``
    uneven = {n for n, s in sizes.items()
              if any(x % _rule_extent(n) for x in s)}
    blocks = {n: g for n in uneven
              if (g := math.gcd(_rule_extent(n), *sizes[n])) > 1}
    cut = {n: _block_of(mesh, rules, n, g) for n, g in blocks.items()}
    pl = lambda axes: placements(logical_to_pspec(
        tuple(None if n in uneven else n for n in axes), rules), mesh)
    whole = lambda a: (a if hasattr(a, "placements") else DTensor.from_local(
        a, mesh, [Replicate()] * mesh.ndim, run_check=False))
    args = tuple(a if ax is None else shard(whole(a), *(
        None if n in uneven else n for n in ax))
        for a, ax in zip(args, in_axes))
    ins = tuple(None if ax is None else pl(ax) for ax in in_axes)
    cut_dims = {m for n in blocks for m in _mesh_dims(mesh, rules, n)}
    split = cut_dims | {m for p in ins if p is not None
                        for m, q in enumerate(p) if q.is_shard()}
    grads = tuple(None if p is None else tuple(
        Partial() if q == Replicate() and m in split else q
        for m, q in enumerate(p)) for p in ins)
    outs = tuple(pl(ax) for ax in out_axes)
    if not blocks:
        return local_map(fn, out_placements=outs, in_placements=ins,
                         in_grad_placements=grads, device_mesh=mesh)(*args)

    # each output is whole again as the sum of its blocks: one without a
    # cut axis would be added once a block
    for ax in out_axes:
        if set(cut) - set(ax):
            raise ValueError(
                f"local_call: an output on axes {ax} lacks the axes "
                f"{sorted(set(cut) - set(ax))} cut into blocks")
    first = all(f for _, _, f in cut.values())

    def blockwise(*local):
        res = fn(*(a if ax is None else _take_blocks(a, ax, cut)
                   for a, ax in zip(local, in_axes)))
        one = not isinstance(res, tuple)
        for r in (res,) if one else res:
            if not r.is_floating_point():
                raise TypeError(
                    f"local_call: a {r.dtype} output of blocks of "
                    f"{sorted(cut)}; only floating outputs are summed")
        res = tuple(_put_blocks(r, ax, cut, first)
                    for r, ax in zip((res,) if one else res, out_axes))
        return res[0] if one else res

    summed = tuple(tuple(Partial() if m in cut_dims and q == Replicate()
                         else q for m, q in enumerate(p)) for p in outs)
    res = local_map(blockwise, out_placements=summed, in_placements=ins,
                    in_grad_placements=grads, device_mesh=mesh)(*args)
    one = not isinstance(res, tuple)
    res = tuple(r.redistribute(mesh, p)
                for r, p in zip((res,) if one else res, outs))
    return res[0] if one else res


def _mesh_dims(mesh, rules: dict, name: str) -> list[int]:
    """The mesh dims (major to minor) logical axis ``name`` maps to."""
    from ..distributed.sharding import axis_names

    entry = rules.get(name)
    axes = () if entry is None else (
        (entry,) if isinstance(entry, str) else tuple(entry))
    return [axis_names(mesh).index(a) for a in axes]


def _block_of(mesh, rules: dict, name: str, g: int) -> tuple[int, int, bool]:
    """``(g, block, first)``: this rank's block of logical axis ``name``
    cut into ``g`` blocks over its mesh dims, and whether the rank is the
    block's first replica (rank ``c`` of the axis's ``extent`` holds block
    ``c % g``; ranks ``0 .. g-1`` are the first replicas)."""
    coord = mesh.get_coordinate()
    c = 0
    for m in _mesh_dims(mesh, rules, name):
        c = c * mesh.size(m) + coord[m]
    return g, c % g, c < g


def _take_blocks(a: torch.Tensor, axes: tuple, cut: dict) -> torch.Tensor:
    """``a``'s block along each of its dims whose logical axis is cut."""
    for d, n in enumerate(axes):
        if n in cut:
            g, b, _ = cut[n]
            w = a.shape[d] // g
            a = a.narrow(d, b * w, w)
    return a


def _put_blocks(r: torch.Tensor, axes: tuple, cut: dict,
                first: bool) -> torch.Tensor:
    """A block output ``r`` at its place in a zero tensor of the whole
    size along each cut dim; zeros (and a zero gradient) on a rank that is
    not the first replica of its blocks, so the ranks' sum is the whole."""
    r = _FirstReplica.apply(r, first)
    for d, n in enumerate(axes):
        if n in cut:
            g, b, _ = cut[n]
            w = r.shape[d]
            pad = [0, 0] * (r.dim() - 1 - d) + [b * w, (g - 1 - b) * w]
            r = F.pad(r, pad)
    return r


class _FirstReplica(torch.autograd.Function):
    """The identity on a block's first replica; zeros, value and gradient,
    on the others."""

    @staticmethod
    def forward(ctx, x, first):
        ctx.first = first
        return x.view_as(x) if first else torch.zeros_like(x)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.first else torch.zeros_like(g)), None


def param_shardings(specs, mesh, rules: dict[str, Any]):
    """:class:`repro_torch.distributed.sharding.NamedSharding` tree for a
    ParamSpec tree under the given rules."""
    from ..distributed.sharding import NamedSharding

    return map_tree(lambda s: NamedSharding(mesh, logical_to_pspec(s.axes, rules)),
                    specs)


def map_tree(fn, tree):
    """``fn`` applied to every leaf of a nested dict (parameter and spec
    trees)."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    return fn(tree)


def take_layer(tree, i: int):
    """Views of entry ``i`` along the leading (stacked ``layers``) axis of
    every leaf of ``tree``."""
    return map_tree(lambda a: a[i], tree)


def layer_views(tree, n: int) -> list:
    """``[take_layer(tree, i) for i in range(n)]``, through one ``unbind`` a
    leaf: the backward then stacks a leaf's ``n`` gradients once, where
    ``n`` separate views would each add a zero-padded gradient of the whole
    stacked leaf (``n`` times its size, for each layer)."""
    unbound = map_tree(lambda a: a.unbind(0), tree)
    return [map_tree(lambda views: views[i], unbound) for i in range(n)]


def remat_call(fn, *args, remat: bool = True):
    """``fn(*args)``, its activations recomputed in the backward when
    ``remat`` (the reference's checkpointing of a layer body):
    only the arguments and the result are kept.  With grad mode off there
    is no backward, so ``fn`` runs as it is.  Nothing random or stateful
    may run inside ``fn``: the recomputation must give the first pass's
    bits."""
    if remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def embed(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    """Rows of ``params["embed"]`` (in :data:`DTYPE`) for integer tokens.
    On a mesh each rank looks up its own batch rows in the whole table (the
    table gathered, as the FSDP axes gather every weight; DTensor's
    index backward is not dependable across PyTorch versions)."""
    out = ("batch",) + (None,) * tokens.dim()
    return local_call(_lookup, ((None, None), out[:-1]), (out,),
                      params["embed"], tokens)


def _lookup(table, tokens):
    return table.to(DTYPE)[tokens.long()]


# ---------------------------------------------------------------------------
# Normalization
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * gamma


def layer_norm(
    x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype) * gamma + beta


# ---------------------------------------------------------------------------
# Rotary position embedding
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 1e4) -> torch.Tensor:
    """Apply RoPE. x: (..., seq, heads, head_dim); positions: (..., seq)."""
    half = x.shape[-1] // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freqs = theta ** exps
    angles = positions[..., :, None].float() * freqs  # (..., seq, hd/2)
    angles = angles[..., :, None, :]  # broadcast over heads
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (prefill: dense or blockwise-causal; decode: cached)
# ---------------------------------------------------------------------------

def attention(
    q: torch.Tensor,             # (B, S, Hq, D)
    k: torch.Tensor,             # (B, S, Hkv, D)
    v: torch.Tensor,             # (B, S, Hkv, D)
    *,
    causal: bool = True,
    sliding_window: int | None = None,
    block_kv: int = 1024,
) -> torch.Tensor:
    """Grouped-query attention for a whole sequence.

    ``S <= block_kv``: one dense block.  Otherwise KV is processed in chunks
    of ``block_kv`` with an online softmax, so the S x S score matrix is never
    formed, forward or backward (the reference's blockwise attention and
    its custom backward, :class:`_FlashFn`).  Query heads
    stay grouped (B, S, Hkv, rep, D), so repeated KV is never formed, save
    on a mesh whose model axes divide the query heads and not the KV heads.
    """
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    n = _rule_extent("heads")
    if Hkv % n and not Hq % n:
        # on a mesh whose model axes divide the query heads but not the KV
        # heads, GSPMD tiles the heads over (KV head, group); DTensor cannot
        # shard one tensor dim over two, so each KV head is repeated over
        # its group and every head shards as the query heads do
        k, v = (shard(t[:, :, :, None].expand(B, S, Hkv, Hq // Hkv, D)
                      .reshape(B, S, Hq, D), "batch", None, "heads", None)
                for t in (k, v))
        Hkv = Hq
    rep = Hq // Hkv
    if S <= block_kv:  # small enough: single dense block
        scale = 1.0 / math.sqrt(D)
        qg = split_dim(q, 2, (Hkv, rep)).float() * scale
        return _attn_dense(qg, k, v, causal, sliding_window).to(q.dtype)
    win = 0 if sliding_window is None else int(sliding_window)
    # on a mesh: each rank's (batch, head) block alone; heads the model
    # axes do not divide are split as GSPMD splits them (``local_call``),
    # each block of query heads beside its KV heads
    ax = ("batch", None, "heads", None)
    return local_call(_FlashFn.apply, (ax, ax, ax, None, None, None), (ax,),
                      q, k, v, bool(causal), win, int(block_kv))


def _rule_extent(name: str) -> int:
    """How many shards the active mesh context's rule for logical axis
    ``name`` makes (1 without a context)."""
    if not _MESH_CTX:
        return 1
    from ..distributed.sharding import axis_size

    mesh, rules = _MESH_CTX[-1]
    entry = rules.get(name)
    axes = () if entry is None else (
        (entry,) if isinstance(entry, str) else tuple(entry))
    n = 1
    for a in axes:
        n *= axis_size(mesh, a)
    return n


def _flash_mask(q_pos, kv_pos, causal: bool, win: int, S: int):
    mask = (kv_pos < S)[None, :]
    if causal:
        mask = mask & (q_pos[:, None] >= kv_pos[None, :])
    if win:
        mask = mask & (q_pos[:, None] - kv_pos[None, :] < win)
    return mask


def _kv_blocks(k, v, block_kv):
    """k, v padded with zeros to a whole number of ``block_kv`` rows."""
    S = k.shape[1]
    nb = (S + block_kv - 1) // block_kv
    pad = nb * block_kv - S
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    return k, v, nb


def _flash_fwd(q, k, v, causal, win, block_kv):
    """The blockwise forward: ``(out (B,S,Hq,D) in q's dtype, lse
    (B,Hkv,rep,S) float32)``, ``lse = m + log(l)`` of each query row."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    rep = Hq // Hkv
    scale = 1.0 / math.sqrt(D)
    qg = q.reshape(B, S, Hkv, rep, D).float() * scale
    k, v, nb = _kv_blocks(k, v, block_kv)
    dev = q.device
    q_pos = torch.arange(S, device=dev)
    acc = torch.zeros((B, Hkv, rep, S, D), dtype=torch.float32, device=dev)
    m = torch.full((B, Hkv, rep, S), -math.inf, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Hkv, rep, S), dtype=torch.float32, device=dev)
    for blk in range(nb):
        kb = k[:, blk * block_kv:(blk + 1) * block_kv].float()
        vb = v[:, blk * block_kv:(blk + 1) * block_kv].float()
        kv_pos = blk * block_kv + torch.arange(block_kv, device=dev)
        s_ij = torch.einsum("bqhrd,bkhd->bhrqk", qg, kb)
        mask = _flash_mask(q_pos, kv_pos, causal, win, S)
        s_ij = torch.where(mask[None, None, None], s_ij, -math.inf)
        m_new = torch.maximum(m, s_ij.amax(dim=-1))
        m_safe = torch.where(torch.isinf(m_new), 0.0, m_new)
        p = torch.where(torch.isinf(s_ij), 0.0,
                        torch.exp(s_ij - m_safe[..., None]))
        corr = torch.where(torch.isinf(m), 0.0, torch.exp(m - m_safe))
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhrqk,bkhd->bhrqd", p, vb)
        m = m_new
    l_safe = torch.clamp(l, min=1e-37)
    out = acc / l_safe[..., None]                         # (B,Hkv,rep,S,D)
    lse = m + torch.log(l_safe)                           # (B,Hkv,rep,S)
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, Hq, D).to(q.dtype), lse


def _flash_bwd(q, k, v, out, lse, g, causal, win, block_kv):
    """The reference's blockwise backward (``_flash_bwd``): each KV block's
    probabilities are recomputed from ``lse``; dq accumulates over blocks,
    dk and dv are a block's own.  Returns (dq, dk, dv) in the inputs'
    dtypes."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    rep = Hq // Hkv
    scale = 1.0 / math.sqrt(D)
    qg = q.reshape(B, S, Hkv, rep, D).float()
    do = g.reshape(B, S, Hkv, rep, D).float().permute(0, 2, 3, 1, 4)
    of = out.reshape(B, S, Hkv, rep, D).float().permute(0, 2, 3, 1, 4)
    delta = torch.sum(do * of, dim=-1)                   # (B,Hkv,rep,S)
    kp, vp, nb = _kv_blocks(k, v, block_kv)
    dev = q.device
    q_pos = torch.arange(S, device=dev)
    dq = torch.zeros((B, S, Hkv, rep, D), dtype=torch.float32, device=dev)
    dks, dvs = [], []
    for blk in range(nb):
        kf = kp[:, blk * block_kv:(blk + 1) * block_kv].float()
        vf = vp[:, blk * block_kv:(blk + 1) * block_kv].float()
        kv_pos = blk * block_kv + torch.arange(block_kv, device=dev)
        s_ij = torch.einsum("bqhrd,bkhd->bhrqk", qg * scale, kf)
        mask = _flash_mask(q_pos, kv_pos, causal, win, S)
        p = torch.where(mask[None, None, None],
                        torch.exp(s_ij - lse[..., None]), 0.0)
        del s_ij
        dvs.append(torch.einsum("bhrqk,bhrqd->bkhd", p, do))
        dp = torch.einsum("bhrqd,bkhd->bhrqk", do, vf)
        ds = p * (dp - delta[..., None]) * scale
        del p, dp
        dq = dq + torch.einsum("bhrqk,bkhd->bqhrd", ds, kf)
        dks.append(torch.einsum("bhrqk,bqhrd->bkhd", ds, qg))
        del ds
    dk = torch.cat(dks, dim=1)[:, :S]
    dv = torch.cat(dvs, dim=1)[:, :S]
    return (dq.reshape(B, S, Hq, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


class _FlashFn(torch.autograd.Function):
    """Blockwise attention with the reference's custom VJP: the residuals
    are ``out`` (q's dtype) and the float32 ``lse``, never an S x S
    tensor; the backward recomputes each block."""

    @staticmethod
    def forward(ctx, q, k, v, causal, win, block_kv):
        out, lse = _flash_fwd(q, k, v, causal, win, block_kv)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, win, block_kv)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd(q, k, v, out, lse, g, *ctx.args)
        return dq, dk, dv, None, None, None


def _attn_dense(qg, k, v, causal, sliding_window):
    """qg: (B,S,Hkv,rep,D) fp32 pre-scaled; k, v: (B,S,Hkv,D)."""
    S = qg.shape[1]
    s = torch.einsum("bqhrd,bkhd->bhrqk", qg, k.float())
    q_pos = torch.arange(S, device=qg.device)
    mask = torch.ones((S, S), dtype=torch.bool, device=qg.device)
    if causal:
        mask &= q_pos[:, None] >= q_pos[None, :]
    if sliding_window is not None:
        mask &= q_pos[:, None] - q_pos[None, :] < sliding_window
    s = torch.where(mask[None, None, None], s, -math.inf)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhrqk,bkhd->bqhrd", p, v.float())
    return merge_dims(out, 2)


def decode_attention(
    q: torch.Tensor,             # (B, 1, Hq, D)
    k_cache: torch.Tensor,       # (B, S_max, Hkv, D)
    v_cache: torch.Tensor,
    cache_len,                   # int or (B,) valid lengths
) -> torch.Tensor:
    """Single-token attention against a KV cache.

    Works unchanged for sliding-window ring buffers: keys are stored
    post-RoPE with absolute positions, so scores depend only on relative
    position and the physical slot order inside the ring is irrelevant;
    the window is enforced by the ring size and ``cache_len`` counts
    valid (written) slots clamped to the ring capacity.
    """
    B, S_max, Hkv, D = k_cache.shape
    Hq = q.shape[2]
    n_rep = Hq // Hkv
    scale = 1.0 / math.sqrt(D)
    qf = q.float() * scale                        # (B, 1, Hq, D)
    kf = k_cache.float()
    vf = v_cache.float()
    if n_rep > 1:
        qf = split_dim(qf, 2, (Hkv, n_rep))
        s = torch.einsum("bqhrd,bkhd->bhrqk", qf, kf)   # (B,Hkv,rep,1,S)
    else:
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kf)[:, :, None]
    idx = torch.arange(S_max, device=q.device)
    lens = torch.as_tensor(cache_len, device=q.device).reshape(-1, 1)
    valid = idx[None, :] < lens
    s = torch.where(valid[:, None, None, None, :], s, -math.inf)
    p = torch.softmax(s, dim=-1)
    p = torch.where(torch.isnan(p), 0.0, p)       # fully-masked rows
    out = torch.einsum("bhrqk,bkhd->bqhrd", p, vf)
    return out.reshape(B, 1, Hq, D).to(q.dtype)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def mlp(x: torch.Tensor, w: dict, kind: str = "swiglu") -> torch.Tensor:
    """SwiGLU (w: wi_gate, wi_up, wo) or GELU (w: wi, wo) feed-forward."""
    if kind == "swiglu":
        g = x @ w["wi_gate"]
        u = x @ w["wi_up"]
        h = F.silu(g.float()).to(x.dtype) * u
    else:
        h = x @ w["wi"]
        h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    h = shard(h, "batch", "seq", "mlp")
    return reduce_proj(h, w["wo"], "batch", "seq_res", "embed")
