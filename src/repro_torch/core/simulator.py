"""Deprecation shim: the simulator now lives in
:mod:`repro_torch.core.sim`.

``repro_torch.core.simulator`` re-exports the full public API of the old
monolithic module so existing imports keep working:

  * the generic event loop (:func:`simulate`) and sources
    (:func:`microbenchmark_source`, :func:`trace_source`)
  * :class:`SimConfig` / :class:`SimResult` / :class:`Op`
  * the suboperation kind constants ``MEM``/``PREIO``/``POSTIO``/``CPU``
  * :func:`best_over_threads`

New code should import from :mod:`repro_torch.core.sim`, which additionally
provides the compiled fast loop (:func:`simulate_compiled`) and the batched
sweep pipeline (:func:`sweep_latency`).
"""
from __future__ import annotations

import warnings

from .sim import (  # noqa: F401
    CPU,
    MEM,
    POSTIO,
    PREIO,
    US,
    CompiledTrace,
    Op,
    SimConfig,
    SimResult,
    best_over_threads,
    microbenchmark_source,
    simulate,
    simulate_compiled,
    sweep_latency,
    trace_source,
)

__all__ = [
    "SimConfig",
    "SimResult",
    "Op",
    "simulate",
    "microbenchmark_source",
    "trace_source",
    "best_over_threads",
]

# stacklevel=2 attributes the warning to the importing file: CPython's warn
# walks past its own importlib frames when counting stack levels, so level 2
# of a module body *is* the caller's ``import repro_torch.core.simulator``
# line.
warnings.warn(
    "repro_torch.core.simulator is deprecated: the simulation layer lives "
    "in repro_torch.core.sim (e.g. 'from repro_torch.core.sim import "
    "SimConfig, simulate, sweep_latency'); the compiled fast loop "
    "(simulate_compiled) and the batched sweep pipeline (sweep_latency) "
    "are only exported there. "
    "See docs/ENGINES.md for the migration map.",
    DeprecationWarning,
    stacklevel=2,
)
