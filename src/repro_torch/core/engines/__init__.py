"""SSD-based KV-store engines mirroring the paper's three modified stores.

The paper modifies Aerospike, RocksDB and CacheLib so their large in-memory
indices/caches live on microsecond-latency memory and every access to them is
a prefetch+yield.  We implement the *data-structure cores* of those three
designs (Fig. 13) as real Python/numpy structures:

  * :class:`TreeIndexStore`    (``tree-index`` / ``aerospike-like``)
  * :class:`LSMStore`          (``lsm`` / ``rocksdb-like``)
  * :class:`TwoTierCacheStore` (``two-tier-cache`` / ``cachelib-like``)

plus two more points of the paper's index/cache design space:

  * :class:`HashIndexStore`    (``hash-index`` / ``open-addressing``)
  * :class:`SlabCacheStore`    (``slab-cache`` / ``memcached-like``)

Running a workload through :func:`run_trace` produces a columnar
:class:`~repro_torch.core.trace_ir.CompiledTrace` in which every pointer
dereference on slow memory is a MEM subop and every SSD access a
PREIO/POSTIO pair -- exactly the operation model of Sec. 3.  The trace is
executed by :mod:`repro_torch.core.sim` to obtain throughput vs. memory latency,
and summarized into ``OpParams`` so the closed-form model of
:mod:`repro_torch.core.latency_model` can be compared against the "measurement"
(Figs. 11(c)(d)(e)).

Only reads/updates go through the traced path; bulk loading is untraced
(the paper also measures after load + warm-up).

New engines implement the :class:`KVEngine` protocol (``op()``, ``times``,
``stats()``) and self-register via :func:`register_engine`; everything
downstream (tracer, sweep pipeline, benchmarks) picks them up by
name.
"""
from .base import (  # noqa: F401
    EngineTimes,
    KVEngine,
    available_engines,
    create_engine,
    get_engine,
    register_engine,
)
from .trace import Recorder, TraceResult, run_trace  # noqa: F401
from .tree_index import TreeIndexStore  # noqa: F401
from .lsm import LSMStore  # noqa: F401
from .two_tier_cache import TwoTierCacheStore  # noqa: F401
from .hash_index import HashIndexStore  # noqa: F401
from .slab_cache import SlabCacheStore  # noqa: F401

__all__ = [
    "EngineTimes",
    "KVEngine",
    "Recorder",
    "TraceResult",
    "run_trace",
    "TreeIndexStore",
    "LSMStore",
    "TwoTierCacheStore",
    "HashIndexStore",
    "SlabCacheStore",
    "register_engine",
    "get_engine",
    "create_engine",
    "available_engines",
]
