"""Discrete-event simulation of the paper's execution model (the "FPGA
testbed"), as a layered package:

  * :mod:`.config`      -- :class:`SimConfig` / :class:`SimResult`
  * :mod:`.arrivals`    -- open-loop arrival processes (Poisson, bursty,
                           diurnal, multi-tenant mixes) and the sojourn
                           tail-latency accumulator shared by all backends
  * :mod:`.devices`     -- memory-latency sampling, per-SSD token clocks
                           (``n_ssd`` devices, round-robin striping, switch
                           fan-out hop), per-core prefetch queue + throttle
  * :mod:`.scheduler`   -- threads, cores, FIFO ready rings, parked heap
  * :mod:`.engine_loop` -- the generic event loop and the compiled
                           single-core fast loop over columnar traces
  * :mod:`.sweep`       -- the batched latency x threads sweep pipeline
                           (``backend="torch"`` vectorized device grid or
                           ``backend="loop"`` interpreter cells)
  * :mod:`.replay_torch` -- the torch backend: the compiled trace lowered
                           to device tensors and the whole grid replayed by
                           the fused CUDA step kernel (imported lazily --
                           importing torch is heavyweight)

The paper measures KV-operation throughput on real hardware whose memory
latency is made adjustable by an FPGA CXL board.  This container has no
such hardware, so we reproduce the *measurement apparatus* in virtual time
with exactly the paper's free parameters: N threads per core with strict
FIFO scheduling and per-yield context-switch cost T_sw, software prefetch
with per-core queue depth P, stall-on-incomplete-prefetch (the gray bars of
Figs. 5 and 8), asynchronous IO striped over one or more SSDs each gated by
its own bandwidth/IOPS token clocks (plus an optional CXL-switch fan-out
hop), memory-bandwidth throttling, DRAM tiering, premature eviction,
tail-latency mixtures, and a global per-op critical section.

Operations come from an ``OpSource`` callable (microbenchmark or legacy
trace replay) or, on the fast path, from a columnar
:class:`~repro_torch.core.trace_ir.CompiledTrace` recorded by the engines in
:mod:`repro_torch.core.engines`.
"""
from ..trace_ir import CPU, MEM, POSTIO, PREIO, US, CompiledTrace, Op  # noqa: F401
from .arrivals import (  # noqa: F401
    HIST_REL_ERROR,
    ArrivalSpec,
    LatencySummary,
    generate_arrivals,
    summarize_exact,
    summarize_hist,
)
from .config import SimConfig, SimResult  # noqa: F401
from .devices import PrefetchUnit, SSDClocks, sample_lmem  # noqa: F401
from .engine_loop import (  # noqa: F401
    best_over_threads,
    microbenchmark_source,
    simulate,
    simulate_compiled,
    trace_source,
)
from .scheduler import Core, ParkedHeap, Thread  # noqa: F401
from .sweep import (  # noqa: F401
    BACKENDS,
    SweepPoint,
    clear_sweep_cache,
    prune_sweep_cache,
    sweep_latency,
)

__all__ = [
    "US",
    "MEM",
    "PREIO",
    "POSTIO",
    "CPU",
    "Op",
    "CompiledTrace",
    "SimConfig",
    "SimResult",
    "simulate",
    "simulate_compiled",
    "microbenchmark_source",
    "trace_source",
    "best_over_threads",
    "sweep_latency",
    "SweepPoint",
    "BACKENDS",
    "clear_sweep_cache",
    "prune_sweep_cache",
    "ArrivalSpec",
    "LatencySummary",
    "generate_arrivals",
    "summarize_exact",
    "summarize_hist",
    "HIST_REL_ERROR",
]
