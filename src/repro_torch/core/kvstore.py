"""Deprecation shim: the KV engines now live in
:mod:`repro_torch.core.engines`.

``repro_torch.core.kvstore`` re-exports the old module's public API so
existing imports keep working:

  * the three engines (:class:`TreeIndexStore`, :class:`LSMStore`,
    :class:`TwoTierCacheStore`) and their :class:`EngineTimes`
  * the tracing machinery (:class:`Recorder`, :class:`TraceResult`,
    :func:`run_trace`)

New code should import from :mod:`repro_torch.core.engines`, which
additionally provides the :class:`KVEngine` protocol and the engine registry
(:func:`register_engine` / :func:`get_engine` / :func:`create_engine`).
"""
from __future__ import annotations

import warnings

# The pre-refactor module also exposed these at module level (it imported
# them for its own use); legacy `from repro_torch.core.kvstore import ...`
# lines must keep resolving them.
from .latency_model import OpParams, US  # noqa: F401
from .trace_ir import CPU, MEM, POSTIO, PREIO, Op  # noqa: F401
from .workloads import Workload  # noqa: F401
from .engines import (  # noqa: F401
    EngineTimes,
    KVEngine,
    LSMStore,
    Recorder,
    TraceResult,
    TreeIndexStore,
    TwoTierCacheStore,
    available_engines,
    create_engine,
    get_engine,
    register_engine,
    run_trace,
)

__all__ = [
    "EngineTimes",
    "Recorder",
    "TraceResult",
    "TreeIndexStore",
    "LSMStore",
    "TwoTierCacheStore",
    "run_trace",
]

# stacklevel=2 attributes the warning to the importing file: CPython's warn
# walks past its own importlib frames when counting stack levels, so level 2
# of a module body *is* the caller's ``import repro_torch.core.kvstore``
# line.
warnings.warn(
    "repro_torch.core.kvstore is deprecated: the engines live in "
    "repro_torch.core.engines (e.g. 'from repro_torch.core.engines import "
    "LSMStore, run_trace'); model/trace types moved to "
    "repro_torch.core.latency_model / repro_torch.core.trace_ir / "
    "repro_torch.core.workloads. See docs/ENGINES.md for the migration map.",
    DeprecationWarning,
    stacklevel=2,
)
