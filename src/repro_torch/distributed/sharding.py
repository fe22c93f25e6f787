"""Logical-axis -> mesh-axis rules: FSDP x TP x EP (x SP) in one table.

Counterpart of ``repro/distributed/sharding.py``.  Two rule tables, because
the same logical name means different things on a weight and on an
activation:

  * **param rules** -- weights are 2-D sharded: the 'embed' (row) dimension
    is FSDP-sharded over the data axis (and the pod axis on multi-pod
    meshes), while 'mlp' / 'heads_flat' / 'vocab' / 'expert' columns are
    tensor/expert-parallel over the model axis.
  * **activation rules** -- 'batch' is data(+pod)-parallel, the hidden
    'mlp'/'heads' dimensions are model-parallel, 'embed' is replicated.
    'seq' is optionally sequence-parallel (set ``seq_shard=True`` for the
    long-context shapes).

The reference names logical axes and lets GSPMD place every tensor; the
port's counterpart is a ``torch.distributed`` ``DeviceMesh`` with named
dims and DTensors: a spec (the tuple of a PartitionSpec's entries) becomes
DTensor placements through :func:`placements`, a weight is placed with
``distribute_tensor``, ``shard`` (:mod:`repro_torch.models.layers`)
``redistribute``\\ s an activation where the reference constrains it, and
DTensor's sharding propagation carries the rest.

A mesh is anything with named dims: a ``DeviceMesh`` (``mesh_dim_names``,
``size(i)``), or an object with ``axis_names`` (and ``shape``, a dict of
axis sizes), as the reference's tests build.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

from ..models.layers import logical_to_pspec, map_tree, param_shardings

__all__ = [
    "NamedSharding",
    "param_rules",
    "act_rules",
    "state_shardings",
    "batch_shardings",
    "cache_shardings",
    "batch_axes",
    "axis_names",
    "axis_size",
    "placements",
    "place_",
    "mesh_device",
    "full",
]


def axis_names(mesh) -> tuple[str, ...]:
    """The mesh's axis names, major to minor."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        names = mesh.axis_names
    return tuple(names)


def axis_size(mesh, name: str) -> int:
    """The extent of the mesh's axis ``name``."""
    if hasattr(mesh, "mesh_dim_names"):
        return mesh.size(axis_names(mesh).index(name))
    return mesh.shape[name]


def placements(spec: tuple, mesh) -> tuple:
    """DTensor placements (one per mesh dim) for a spec on ``mesh``.

    Entry ``e`` of ``spec`` places tensor dim ``d``: a mesh axis name, or a
    tuple of them, shards ``d`` over each (``Shard(d)`` on those mesh dims);
    ``None`` leaves it whole.  A tuple entry is major to minor, as JAX's,
    and DTensor shards a tensor dim over several mesh dims in mesh order: so
    the entry's axes must come in mesh order.  Mesh dims no entry names
    replicate."""
    from torch.distributed.tensor import Replicate, Shard

    names = axis_names(mesh)
    out: list = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} lists mesh axes out of "
                             f"the mesh's order {names}")
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f"mesh axis {names[i]!r} shards two "
                                 f"dims of spec {spec!r}")
            out[i] = Shard(d)
    return tuple(out)


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the reference's ``NamedSharding``)."""

    mesh: Any
    spec: tuple

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)

    def place(self, x):
        """``x`` (the same whole tensor on every rank) as a DTensor with
        these placements; each rank keeps its own slice (no collective)."""
        from torch.distributed.tensor import distribute_tensor

        return distribute_tensor(x, self.mesh, self.placements,
                                 src_data_rank=None)


def place_(tree, shardings):
    """``tree`` (a nested dict) with each leaf replaced, in place, by its
    DTensor placed by the matching :class:`NamedSharding` of ``shardings``
    (the reference's ``device_put``).  Leaf by leaf: each whole leaf is
    dropped as soon as its DTensor replaces it, so a state of the card's
    size is never held twice."""
    from ..tree import get_leaf, leaf_paths, set_leaf

    for path in [p for p, _ in leaf_paths(tree)]:
        set_leaf(tree, path, get_leaf(shardings, path).place(
            get_leaf(tree, path)))
    return tree


def mesh_device(mesh):
    """The device this rank's shards of ``mesh`` live on."""
    import torch

    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def full(x):
    """A DTensor's whole value as a plain tensor on every rank (a
    collective: every rank of its mesh calls it); anything else as it is."""
    return x.full_tensor() if hasattr(x, "full_tensor") else x


def _batch_axes(mesh):
    return ("pod", "data") if "pod" in axis_names(mesh) else "data"


def batch_axes(mesh):
    return _batch_axes(mesh)


def param_rules(mesh, fsdp: bool = True, policy: str = "baseline") -> dict[str, Any]:
    """Weight sharding: FSDP on 'embed' rows x TP/EP on the model axis.

    Policies (the hillclimb levers, EXPERIMENTS.md SSPerf):
      baseline -- FSDP(data) x TP(model)
      dp2d     -- no tensor parallelism: weights fully sharded over BOTH
                  axes (FSDP over data x model); right for small models
                  where TP all-reduces dominate
      sp       -- baseline weights + sequence-parallel activations
      serve    -- TP-resident weights, NO FSDP: there is no optimizer state
                  at inference, so weights live sharded over the model axis
                  and are never all-gathered (kills the decode cells'
                  dominant collective)
    """
    if policy == "dp2d":
        ba = _batch_axes(mesh)
        both = (ba, "model") if isinstance(ba, str) else (*ba, "model")
        return {
            "embed": both, "embed2": None, "mlp": None, "heads_flat": None,
            "heads": None, "vocab": None, "expert": None, "expert_mlp": None,
            "expert_group": both, "layers": None, "seq": None, "batch": None,
        }
    return {
        "embed": None if (policy == "serve" or not fsdp) else _batch_axes(mesh),
        "embed2": None,
        "mlp": "model",
        "heads_flat": "model",
        "heads": "model",
        "vocab": "model",
        "expert": "model",
        "expert_mlp": None,
        "expert_group": _batch_axes(mesh),
        "layers": None,
        "seq": None,
        "batch": None,
    }


def act_rules(mesh, seq_shard: bool = False, policy: str = "baseline") -> dict[str, Any]:
    """Activation sharding: DP batch, TP hidden, optional SP sequence."""
    ba = _batch_axes(mesh)
    if policy == "dp2d":
        both = (ba, "model") if isinstance(ba, str) else (*ba, "model")
        return {
            "batch": both, "seq": None, "embed": None, "embed2": None,
            "mlp": None, "heads_flat": None, "heads": None, "vocab": None,
            "expert": None, "expert_mlp": None, "expert_group": both,
            "seq_res": None, "layers": None,
        }
    return {
        "batch": ba,
        "seq": None,  # never 'model': q/k/v constraints carry head sharding
        "seq_res": "model" if (seq_shard or policy == "sp") else None,
        "embed": None,
        "embed2": None,
        "mlp": "model",
        "heads_flat": "model",
        "heads": "model",
        "vocab": "model",
        "expert": "model",
        "expert_mlp": None,
        "expert_group": ba,
        "layers": None,
    }


def state_shardings(specs, mesh, fsdp: bool = True, policy: str = "baseline"):
    """:class:`NamedSharding` tree for a ParamSpec tree (weights + optimizer
    moments, which inherit their parameter's sharding)."""
    return param_shardings(specs, mesh, param_rules(mesh, fsdp, policy))


def _dp_size(mesh, policy: str = "baseline") -> int:
    size = axis_size(mesh, "data")
    if "pod" in axis_names(mesh):
        size *= axis_size(mesh, "pod")
    if policy == "dp2d":
        size *= axis_size(mesh, "model")
    return size


def _shape(s) -> tuple:
    return tuple(s.shape)


def batch_shardings(batch_specs: dict, mesh, policy: str = "baseline") -> dict:
    """Input batches are sharded on their leading (batch) dimension only;
    a batch smaller than the data-parallel extent stays replicated (the
    long_500k single-sequence shapes are model-parallel-only work).

    ``batch_specs`` is a tree of anything with a ``shape`` (tensors, meta
    tensors, ParamSpecs)."""
    ba = _batch_axes(mesh)
    if policy == "dp2d":
        ba = (ba, "model") if isinstance(ba, str) else (*ba, "model")
    dp = _dp_size(mesh, policy)

    def one(s):
        shape = _shape(s)
        lead = ba if shape and shape[0] % dp == 0 else None
        return NamedSharding(mesh, (lead, *([None] * (len(shape) - 1))))

    return map_tree(one, batch_specs)


def cache_shardings(cache_specs, mesh, batch_dim: int = 1):
    """Decode caches: shard the batch dimension (layer-stacked pytrees have
    batch at dim 1) and -- for the big (layers, B, S, H, D) KV stacks --
    the sequence dimension over the model axis, so a 32k x 128-seq cache
    spreads over the whole mesh instead of one data row. Divisibility guards
    keep batch-1 shapes valid."""
    ba = _batch_axes(mesh)
    dp = _dp_size(mesh)
    mp = axis_size(mesh, "model")

    def one(s):
        shape = _shape(s)
        spec: list = [None] * len(shape)
        bd = batch_dim if len(shape) > batch_dim else 0
        if shape and shape[bd] % dp == 0:
            spec[bd] = ba
        if len(shape) >= 5 and shape[2] % mp == 0 and shape[2] >= mp * 128:
            spec[2] = "model"
        return NamedSharding(mesh, tuple(spec))

    return map_tree(one, cache_specs)
