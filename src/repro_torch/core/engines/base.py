"""Engine protocol, shared timing constants, and the engine registry.

An *engine* is the data-structure core of one SSD-based KV store whose
index/cache lives on microsecond-latency memory (the paper's Fig. 13
modifications).  Engines do two things: mutate their real in-memory
structures, and record every slow-memory hop / SSD access of the operation
into a :class:`~repro_torch.core.engines.trace.Recorder`.  Everything downstream
(simulator, analytical model, benchmarks) consumes only the recorded trace,
so new engines plug in without touching the simulation layer.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, Callable, Protocol, runtime_checkable

from ..trace_ir import US

if TYPE_CHECKING:  # pragma: no cover
    from .trace import Recorder

__all__ = [
    "EngineTimes",
    "KVEngine",
    "register_engine",
    "get_engine",
    "create_engine",
    "available_engines",
]


@dataclass(frozen=True)
class EngineTimes:
    """CPU-time constants of one engine's suboperations (calibratable)."""

    t_mem: float = 0.10 * US      # compute attached to one slow-memory hop
    t_io_pre: float = 1.5 * US    # IO submission (io_uring sqe prep + submit)
    t_io_post: float = 0.2 * US   # completion check + copy
    t_probe: float = 0.05 * US    # a DRAM-side probe (hash, fence index)
    t_value: float = 0.3 * US     # value (de)serialization / checksum


@runtime_checkable
class KVEngine(Protocol):
    """What the tracer and benchmarks require of an engine."""

    times: EngineTimes

    def op(self, k: int, is_write: bool, rec: "Recorder") -> None:
        """Execute one KV operation, recording its suboperations."""
        ...

    def stats(self) -> dict:
        """Engine-specific hit/occupancy statistics (may be empty)."""
        ...


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, type] = {}


def register_engine(name: str, *aliases: str) -> Callable[[type], type]:
    """Class decorator: register an engine under ``name`` (+ aliases).

    The first name is canonical and is stamped on the class as
    ``cls.engine_name`` so callers holding a class (or an alias) can recover
    the one display/config name (benchmarks key workloads by it).
    """

    def deco(cls: type) -> type:
        for key in (name, *aliases):
            if key in _REGISTRY and _REGISTRY[key] is not cls:
                raise ValueError(f"engine name {key!r} already registered")
            _REGISTRY[key] = cls
        cls.engine_name = name
        return cls

    return deco


def get_engine(name: str) -> type:
    """Look up an engine class by registered name or alias.

    CLI-style underscores are accepted for any registered name
    (``two_tier_cache`` == ``two-tier-cache``).
    """
    cls = _REGISTRY.get(name) or _REGISTRY.get(name.replace("_", "-"))
    if cls is None:
        raise KeyError(
            f"unknown engine {name!r}; known: {sorted(_REGISTRY)}"
        )
    return cls


def create_engine(name: str, *args, **kwargs):
    """Instantiate a registered engine by name."""
    return get_engine(name)(*args, **kwargs)


def available_engines() -> dict[str, type]:
    """Snapshot of the registry (canonical names and aliases alike)."""
    return dict(_REGISTRY)
