"""Key-distribution and read-write-mix workload generators (Table 5).

The paper drives Aerospike with uniform / Zipf-1.1 keys, RocksDB with
Zipf-0.99 / Zipf-0.8, and CacheLib with Gaussian and the CacheBench
"graph cache leader" key distribution; read:write mixes are 1:0, 2:1, 1:1.

Generators self-register in a registry mirroring the engine registry in
:mod:`repro_torch.core.engines.base`: :func:`get_workload` resolves canonical
names, aliases, and CLI-style underscores, and :func:`create_workload`
instantiates by name -- which is what lets a declarative
:class:`~repro_torch.core.experiment.Scenario` name its workload as plain data.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Iterator

import numpy as np

__all__ = [
    "Workload",
    "uniform",
    "zipf",
    "drifting_zipf",
    "gaussian",
    "graph_cache_leader",
    "register_workload",
    "get_workload",
    "create_workload",
    "available_workloads",
]


@dataclass(frozen=True)
class Workload:
    """A stream of (key, is_write) pairs over an integer key space."""

    name: str
    keys: np.ndarray           # int64 key ids in [0, n_keys)
    is_write: np.ndarray       # bool per op
    n_keys: int

    def __len__(self) -> int:
        return len(self.keys)

    def pairs(self) -> Iterator[tuple[int, bool]]:
        return zip(self.keys.tolist(), self.is_write.tolist())


# ---------------------------------------------------------------------------
# Registry (mirrors the engine registry in repro_torch.core.engines.base)
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, Callable[..., Workload]] = {}


def register_workload(name: str, *aliases: str) -> Callable[[Callable], Callable]:
    """Decorator: register a workload factory under ``name`` (+ aliases).

    The first name is canonical and is stamped on the factory as
    ``fn.workload_name`` so callers holding an alias can recover the one
    display/config name (scenario specs serialize it).  Factories take
    ``(n_keys, n_ops, **kwargs)`` and return a :class:`Workload`.
    """

    def deco(fn: Callable) -> Callable:
        for key in (name, *aliases):
            if key in _REGISTRY and _REGISTRY[key] is not fn:
                raise ValueError(f"workload name {key!r} already registered")
            _REGISTRY[key] = fn
        fn.workload_name = name
        return fn

    return deco


def get_workload(name: str) -> Callable[..., Workload]:
    """Look up a workload factory by registered name or alias.

    CLI-style underscores are accepted for any registered name
    (``graph_cache_leader`` == ``graph-cache-leader``).
    """
    fn = _REGISTRY.get(name) or _REGISTRY.get(name.replace("_", "-"))
    if fn is None:
        raise KeyError(
            f"unknown workload {name!r}; known: {sorted(_REGISTRY)}"
        )
    return fn


def create_workload(name: str, n_keys: int, n_ops: int, **kwargs) -> Workload:
    """Instantiate a registered workload by name."""
    return get_workload(name)(n_keys, n_ops, **kwargs)


def available_workloads() -> dict[str, Callable[..., Workload]]:
    """Snapshot of the registry (canonical names and aliases alike)."""
    return dict(_REGISTRY)


def _mix(n_ops: int, read_write: tuple[int, int], rng: np.random.Generator):
    r, w = read_write
    if w == 0:
        return np.zeros(n_ops, dtype=bool)
    return rng.random(n_ops) < (w / (r + w))


@register_workload("uniform")
def uniform(
    n_keys: int, n_ops: int, read_write=(1, 0), seed: int = 0
) -> Workload:
    rng = np.random.default_rng(seed)
    return Workload(
        "uniform", rng.integers(0, n_keys, n_ops), _mix(n_ops, read_write, rng), n_keys
    )


@register_workload("zipf", "zipfian")
def zipf(
    n_keys: int, n_ops: int, exponent: float = 0.99, read_write=(1, 0), seed: int = 0
) -> Workload:
    """Bounded Zipf over [0, n_keys): P(rank r) ~ 1 / r^exponent.

    Ranks are scattered over the key space with a fixed permutation hash so
    hot keys are not spatially clustered (as in real stores).
    """
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, n_keys + 1, dtype=np.float64)
    pmf = ranks ** (-exponent)
    cdf = np.cumsum(pmf)
    cdf /= cdf[-1]
    draws = np.searchsorted(cdf, rng.random(n_ops))
    # multiplicative-hash permutation of ranks -> key ids
    keys = (draws.astype(np.uint64) * np.uint64(2654435761)) % np.uint64(n_keys)
    return Workload(
        f"zipf{exponent}", keys.astype(np.int64), _mix(n_ops, read_write, rng), n_keys
    )


@register_workload("drifting-zipf", "zipf-drift")
def drifting_zipf(
    n_keys: int, n_ops: int, exponent0: float = 0.6, exponent1: float = 1.2,
    n_segments: int = 16, read_write=(1, 0), seed: int = 0
) -> Workload:
    """Zipf whose skew drifts linearly from ``exponent0`` to ``exponent1``
    across the op stream -- the open-loop companion to the time-varying
    arrival processes in :mod:`repro_torch.core.sim.arrivals` (a store warming up
    or a cache whose working set concentrates over a diurnal cycle).

    The stream is cut into ``n_segments`` equal slices; slice ``i`` draws
    from a bounded Zipf at the segment-midpoint exponent, so the drift is
    piecewise-constant but deterministic in ``(n_keys, n_ops, seed)``.
    Ranks use the same permutation hash as :func:`zipf`, so the *identity*
    of the hot keys is stable while their concentration drifts.
    """
    if n_segments < 1:
        raise ValueError(f"n_segments must be >= 1, got {n_segments}")
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, n_keys + 1, dtype=np.float64)
    u = rng.random(n_ops)
    bounds = np.linspace(0, n_ops, n_segments + 1).astype(np.int64)
    draws = np.empty(n_ops, dtype=np.int64)
    for i in range(n_segments):
        lo, hi = bounds[i], bounds[i + 1]
        if hi <= lo:
            continue
        frac = (i + 0.5) / n_segments
        e = exponent0 + (exponent1 - exponent0) * frac
        cdf = np.cumsum(ranks ** (-e))
        cdf /= cdf[-1]
        draws[lo:hi] = np.searchsorted(cdf, u[lo:hi])
    keys = (draws.astype(np.uint64) * np.uint64(2654435761)) % np.uint64(n_keys)
    return Workload(
        f"drifting_zipf{exponent0}-{exponent1}", keys.astype(np.int64),
        _mix(n_ops, read_write, rng), n_keys
    )


@register_workload("gaussian", "normal")
def gaussian(
    n_keys: int, n_ops: int, sigma_frac: float = 0.08, read_write=(2, 1), seed: int = 0
) -> Workload:
    """CacheBench-style Gaussian popularity around a moving working-set center."""
    rng = np.random.default_rng(seed)
    center = n_keys / 2.0
    keys = rng.normal(center, sigma_frac * n_keys, n_ops)
    keys = np.clip(np.round(keys), 0, n_keys - 1).astype(np.int64)
    return Workload("gaussian", keys, _mix(n_ops, read_write, rng), n_keys)


@register_workload("graph-cache-leader", "gcl")
def graph_cache_leader(
    n_keys: int, n_ops: int, read_write=(2, 1), seed: int = 0
) -> Workload:
    """Approximation of CacheBench's graph-cache-leader key distribution:
    a heavy-tailed mixture -- a small hot set (Zipf 0.9) plus a uniform
    scan component, which is what the Meta social-graph leader traces
    look like (Berg et al., OSDI'20)."""
    rng = np.random.default_rng(seed)
    hot = zipf(max(n_keys // 20, 1), n_ops, 0.9, (1, 0), seed + 1).keys
    cold = rng.integers(0, n_keys, n_ops)
    take_hot = rng.random(n_ops) < 0.8
    keys = np.where(take_hot, hot, cold).astype(np.int64)
    return Workload("graph_cache_leader", keys, _mix(n_ops, read_write, rng), n_keys)
