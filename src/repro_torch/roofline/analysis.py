"""Roofline terms of a dry-run cell, counted from the ops one rank runs.

Counterpart of ``repro/roofline/analysis.py``.  Three terms per (arch x
shape x mesh) cell, in seconds:

  compute    = FLOPs / (chips * PEAK_FLOPS)
  memory     = bytes / (chips * HBM_BW)
  collective = collective link bytes / LINK_BW

The reference reads them from XLA: FLOPs and "bytes accessed" from the
compiled program's ``cost_analysis()``, collectives and dots from its HLO
text.  The port has no compiled program: the dry run runs the step once
under :class:`OpCounter`, a dispatch mode that sees every aten op one rank
runs on its own shards (DTensor's global ops are passed down to their local
ops, and the global ops DTensor runs to propagate shapes are left out), and
records

  * FLOPs of every op ``torch.utils.flop_counter`` knows: the matmul class
    (``mm``, ``addmm``, ``bmm``, ``baddbmm``) and attention/convolution
    kernels; XLA-CPU's ``cost_analysis`` also counts elementwise ops;
  * input + output bytes of every op that makes a tensor and is not a
    view: the unfused upper bound, as XLA-CPU's "bytes accessed" is;
  * operand + output bytes of every matmul-class op (:func:`dot_bytes`, the
    reference's fusion-adjusted HBM estimate);
  * every collective with its kind, output bytes and group size
    (:func:`collective_bytes`);
  * the peak of the bytes held by live storages (the per-device memory).

Hardware constants: an H100 SXM at its 700 W power limit, from the spec
sheet: 989 TFLOP/s dense bf16, 3.35 TB/s HBM3.  The production meshes
((16, 16) and (2, 16, 16)) span more than one 8-card HGX node along both
axes, so a collective's link is the 400 Gb/s NDR NIC each card has:
``LINK_BW`` = 50 GB/s.
"""
from __future__ import annotations

import math
import weakref
from collections import defaultdict
from dataclasses import asdict, dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = [
    "PEAK_FLOPS",
    "HBM_BW",
    "LINK_BW",
    "OpCounter",
    "collective_bytes",
    "dot_bytes",
    "RooflineTerms",
    "model_flops",
    "count_params",
    "active_params",
]

PEAK_FLOPS = 989e12     # H100 SXM, 700 W: dense bf16 tensor-core peak
HBM_BW = 3.35e12        # H100 SXM: HBM3
LINK_BW = 50e9          # one 400 Gb/s NDR NIC per card (inter-node)

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")

#: functional-collective op name -> the reference's HLO collective kind
_KIND = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}
_COLL_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd")

#: the matmul class: the reference's ``dot``
_DOTS = ("mm", "addmm", "bmm", "baddbmm")


def _link_factor(kind: str, n: int) -> float:
    """Per-chip link bytes as a multiple of the op's *output* bytes
    (per-device shapes), assuming ring algorithms:
      all-gather       out * (n-1)/n      (receives every other shard)
      reduce-scatter   out * (n-1)        (input is n x output)
      all-reduce       2 * out * (n-1)/n  (RS + AG on same-size buffer)
      all-to-all       out * (n-1)/n
      collective-permute  out             (point to point)
    """
    if n <= 1:
        return 0.0
    if kind == "all-gather":
        return (n - 1) / n
    if kind == "reduce-scatter":
        return float(n - 1)
    if kind == "all-reduce":
        return 2.0 * (n - 1) / n
    if kind == "all-to-all":
        return (n - 1) / n
    return 1.0  # collective-permute


def collective_bytes(records) -> dict[str, float]:
    """Per-chip link bytes by collective kind from the collectives one rank
    ran: ``records`` maps ``(kind, output bytes, group size)`` to a count
    (:attr:`OpCounter.collectives`).  Each op's output bytes are scaled by
    the ring-traffic factor for its group size; ``"_counts"`` holds the
    number of ops of each kind."""
    out: dict[str, float] = {k: 0.0 for k in _COLLECTIVES}
    counts: dict[str, int] = {k: 0 for k in _COLLECTIVES}
    for (kind, nbytes, n), calls in records.items():
        out[kind] += calls * nbytes * _link_factor(kind, n)
        counts[kind] += calls
    out["_counts"] = counts  # type: ignore[assignment]
    return out


def dot_bytes(ops) -> float:
    """Fusion-adjusted HBM-traffic estimate: operand + output bytes of every
    matmul-class op one rank ran (``ops``: :attr:`OpCounter.ops`, op name
    -> ``[calls, input bytes, output bytes]``).  The reference's definition:
    elementwise and norm ops fuse into the matmuls on the target, so its
    traffic is dominated by matmul operand streams; the raw byte count is
    kept beside it as the upper bound."""
    return float(sum(ops[n][1] + ops[n][2] for n in _DOTS if n in ops))


def _tensors(xs):
    for x in xs:
        if isinstance(x, torch.Tensor):
            yield x
        elif isinstance(x, (list, tuple)):
            yield from _tensors(x)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _Propagating:
    """Marks the global ops DTensor runs (on fake tensors) to propagate a
    result's shape: they are no rank's work.  The propagation's entry point
    is private to DTensor; :class:`OpCounter` wraps it while it counts."""

    depth = 0
    _NAMES = ("_propagate_tensor_meta_non_cached", "_propagate_tensor_meta")

    def __init__(self):
        from torch.distributed.tensor._sharding_prop import ShardingPropagator

        name = next((n for n in self._NAMES
                     if hasattr(ShardingPropagator, n)), None)
        if name is None:
            raise RuntimeError("this PyTorch's DTensor has none of "
                               f"{self._NAMES}: OpCounter cannot tell its "
                               "shape propagation from a rank's work")
        self.cls, self.name = ShardingPropagator, name
        self.orig = getattr(ShardingPropagator, name)

    def __enter__(self):
        orig = self.orig

        def marked(*args, **kwargs):
            _Propagating.depth += 1
            try:
                return orig(*args, **kwargs)
            finally:
                _Propagating.depth -= 1

        setattr(self.cls, self.name, marked)
        return self

    def __exit__(self, *exc):
        setattr(self.cls, self.name, self.orig)


class OpCounter(TorchDispatchMode):
    """Counts the aten ops this rank runs on its own (local) tensors.

    An op on DTensors is handed on (``NotImplemented``): DTensor turns it
    into local ops and collectives, which come back through this mode.
    Works on real tensors and under ``FakeTensorMode`` alike.  Attributes:
    ``flops``; ``bytes`` (inputs + outputs of every op that makes a tensor
    and is not a view);
    ``ops`` (op name -> ``[calls, input bytes, output bytes]``);
    ``collectives`` (``(kind, output bytes, group size)`` -> calls);
    ``live`` / ``peak`` (bytes of live storages: :meth:`hold` registers the
    arguments, every op's new outputs are added, a storage's bytes leave
    when it is freed)."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self._flops_of = flop_registry
        self.flops = 0
        self.bytes = 0
        self.ops: dict[str, list[int]] = defaultdict(lambda: [0, 0, 0])
        self.collectives: dict[tuple, int] = defaultdict(int)
        self.live = 0
        self.peak = 0
        self._held: dict[int, tuple] = {}
        self._prop = _Propagating()

    def __enter__(self):
        self._prop.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._prop.__exit__(*exc)

    def hold(self, tensors) -> None:
        """Count ``tensors``' storages as live (a step's arguments)."""
        for t in tensors:
            self._hold(getattr(t, "_local_tensor", t))

    def _hold(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._held:
            return
        n = st.nbytes()
        self._held[key] = (n, weakref.ref(st, lambda _, k=key: self._free(k)))
        self.live += n
        self.peak = max(self.peak, self.live)

    def _free(self, key) -> None:
        n, _ = self._held.pop(key, (0, None))
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if _Propagating.depth:
            return out
        outs = list(_tensors(out if isinstance(out, (list, tuple)) else (out,)))
        packet = func._overloadpacket
        if func.namespace in _COLL_NAMESPACES:
            kind = _KIND.get(packet.__name__)
            if kind is not None:
                from torch.distributed.distributed_c10d import \
                    _resolve_process_group

                n = _resolve_process_group(args[-1] if isinstance(
                    args[-1], str) else kwargs["group_name"]).size()
                for o in outs:
                    self.collectives[(kind, _nbytes(o), n)] += 1
        if packet in self._flops_of:
            self.flops += self._flops_of[packet](*args, **kwargs,
                                                 out_val=out)
        if outs and not func.is_view:
            n_in = sum(_nbytes(t) for t in _tensors(args))
            n_out = sum(_nbytes(o) for o in outs)
            rec = self.ops[packet.__name__]
            rec[0] += 1
            rec[1] += n_in
            rec[2] += n_out
            self.bytes += n_in + n_out
        for o in outs:
            self._hold(o)
        return out


@dataclass
class RooflineTerms:
    """The reference's row: the ``hlo_`` numbers are counted from the aten
    ops each rank dispatches (:class:`OpCounter`), per device x chips."""

    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float                     # global (sum over chips)
    hlo_bytes: float                     # global, every op's bytes (upper bound)
    coll_bytes_link: float = 0.0         # per-chip link bytes (ring-adjusted)
    hbm_bytes_est: float = 0.0           # global, fusion-adjusted (dot streams)
    coll_by_kind: dict = field(default_factory=dict)
    model_flops: float = 0.0
    per_device_memory: float = 0.0       # bytes (arguments + live temporaries)

    @property
    def t_compute(self) -> float:
        return self.hlo_flops / (self.chips * PEAK_FLOPS)

    @property
    def t_memory(self) -> float:
        b = self.hbm_bytes_est or self.hlo_bytes
        return b / (self.chips * HBM_BW)

    @property
    def t_memory_upper(self) -> float:
        return self.hlo_bytes / (self.chips * HBM_BW)

    @property
    def t_collective(self) -> float:
        return self.coll_bytes_link / LINK_BW

    @property
    def bottleneck(self) -> str:
        t = {"compute": self.t_compute, "memory": self.t_memory,
             "collective": self.t_collective}
        return max(t, key=t.get)

    @property
    def useful_ratio(self) -> float:
        return self.model_flops / self.hlo_flops if self.hlo_flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """compute term / max term: 1.0 == perfectly compute-bound."""
        m = max(self.t_compute, self.t_memory, self.t_collective)
        return self.t_compute / m if m else 0.0

    def row(self) -> dict:
        return {
            **asdict(self),
            "t_compute": self.t_compute,
            "t_memory": self.t_memory,
            "t_memory_upper": self.t_memory_upper,
            "t_collective": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_ratio": self.useful_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def model_flops(cfg, shape, n_params: int, n_active: int) -> float:
    """MODEL_FLOPS: 6*N*D for training, 2*N*D for prefill, 2*N*B for decode
    (N = active params for MoE)."""
    D = shape.global_batch * shape.seq_len
    if shape.kind == "train":
        return 6.0 * n_active * D
    if shape.kind == "prefill":
        return 2.0 * n_active * D
    return 2.0 * n_active * shape.global_batch  # decode: one token per seq


def _spec_leaves(specs):
    if hasattr(specs, "shape") and hasattr(specs, "axes"):
        return [specs]
    if isinstance(specs, dict):
        return [s for v in specs.values() for s in _spec_leaves(v)]
    if isinstance(specs, (list, tuple)):
        return [s for v in specs for s in _spec_leaves(v)]
    return []


def count_params(specs) -> int:
    return int(sum(math.prod(s.shape) for s in _spec_leaves(specs)))


def active_params(cfg, specs) -> int:
    """Active-per-token parameter count (MoE: top_k + shared experts only)."""
    total = count_params(specs)
    if cfg.family != "moe":
        return total
    # subtract the inactive routed experts
    per_expert = 3 * cfg.d_model * cfg.d_expert * cfg.n_layers
    inactive = (cfg.n_experts - cfg.top_k) * per_expert
    return int(total - inactive)
