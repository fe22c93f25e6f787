"""Shared helpers for the port's per-figure benchmarks.

The PyTorch / CUDA port's counterpart of ``benchmarks/common.py``, over
:mod:`repro_torch.core` (that module imports the reference package, so this
one keeps its own copy of what the port's benchmarks need).  Every
benchmark prints CSV rows ``name,us_per_call,derived`` where
``us_per_call`` is the simulated (virtual-time) microseconds per KV
operation at the row's operating point and ``derived`` carries the
figure-specific quantity (normalized throughput, model error, ...).

* :func:`emit` -- the CSV row format;
* :func:`sweep_points` / :func:`sweep_trace` -- raw-source sweeps for the
  microbenchmark figures (sources that are not engine scenarios);
* :func:`run_options` -- the module-level CLI settings (``SWEEP_PROCESSES``,
  ``SWEEP_CACHE``, ``BACKEND``, ``DEVICE``; set by ``benchmarks.run_torch``
  flags) folded into a :class:`~repro_torch.core.experiment.RunOptions`;
* :func:`build_engine` / :func:`build_engines` / :func:`engine_trace`,
  :func:`device_config` and :func:`matrix_sweep` -- the engine and device
  axes;
* :func:`device_missing` -- whether a torch sweep would start without its
  device (the entry points then exit before any work).

``BACKEND`` defaults to ``"torch"`` (the grid on the device) and
``DEVICE`` to ``None`` (the CUDA device): the port's entry points run on
the card unless the caller asks otherwise.  The reference's deprecated
``ENGINE_DEFAULTS`` table and its legacy-override path are not carried
(``docs/PORT.md``): :func:`build_engine` reads
:data:`repro_torch.core.experiment.ENGINE_DEFAULTS` directly.
"""
from __future__ import annotations

from repro_torch.core.engines import run_trace
from repro_torch.core.experiment import (
    Experiment,
    RunOptions,
    default_scenario,
)
from repro_torch.core.experiment import build_engine as _build_engine
from repro_torch.core.latency_model import US
from repro_torch.core.sim import SimConfig, sweep_latency

L_SWEEP_US = (0.1, 0.3, 0.5, 1, 2, 3, 5, 8, 10)
N_CANDIDATES = (16, 24, 32, 48, 64)
MATRIX_L_US = (0.1, 1, 3, 5, 8, 10)

# Set by benchmarks.run_torch from --processes / --sweep-cache / --backend /
# --device; library code should take a RunOptions instead (see
# run_options()).
SWEEP_PROCESSES: int | None = None
SWEEP_CACHE: str | None = None
BACKEND: str = "torch"
DEVICE = None


def run_options(**overrides) -> RunOptions:
    """The benchmark CLI's sweep settings as a :class:`RunOptions`."""
    kw = dict(processes=SWEEP_PROCESSES, cache_dir=SWEEP_CACHE,
              backend=BACKEND, device=DEVICE)
    kw.update(overrides)
    return RunOptions(**kw)


def device_missing(backend: str, device) -> bool:
    """Whether a sweep on ``backend`` and ``device`` needs a CUDA device
    that is not there (``device`` ``None`` or ``"cuda"`` on the torch
    backend; the loop backend and ``device="cpu"`` need none)."""
    if backend != "torch":
        return False
    import torch

    return (torch.device(device or "cuda").type == "cuda"
            and not torch.cuda.is_available())


def emit(name: str, us_per_call: float, derived) -> None:
    print(f"{name},{us_per_call:.4f},{derived}")


def sweep_points(source, l_us_list=L_SWEEP_US, candidates=N_CANDIDATES,
                 n_ops=5000, P=12, seed=7, **cfg_kw):
    """Paper protocol over the fast pipeline: best-over-threads per latency.

    Returns ``{l_us: SweepPoint}`` in input order.  ``source`` is anything
    :func:`sweep_latency` accepts on the CLI's backend (a compiled trace,
    TraceResult or op list; a callable only on ``--backend loop``) -- use
    this for figure sources that are not engine scenarios (microbenchmarks,
    ad-hoc traces); engine sweeps should go through
    :class:`repro_torch.core.experiment.Experiment`.
    """
    cfg = SimConfig(P=P, seed=seed, **cfg_kw)
    opts = run_options()
    pts = sweep_latency(
        cfg,
        source,
        [l_us * US for l_us in l_us_list],
        candidates,
        n_ops=n_ops,
        processes=opts.processes,
        cache_dir=opts.cache_dir,
        backend=opts.backend,
        device=opts.device,
    )
    return dict(zip(l_us_list, pts))


def sweep_trace(src, l_us_list=L_SWEEP_US, n_ops=5000, P=12, seed=7, **cfg_kw):
    """``{l_us: SimResult}`` (the shape of the reference's helper of the
    same name; new code should use :func:`sweep_points`)."""
    pts = sweep_points(src, l_us_list, N_CANDIDATES, n_ops=n_ops, P=P,
                       seed=seed, **cfg_kw)
    return {l_us: pt.result for l_us, pt in pts.items()}


# -- the engine axis ---------------------------------------------------------

def build_engine(name: str, nk: int = 100_000, nops: int = 30_000):
    """One registered engine + its default workload, by any registry name
    (:func:`repro_torch.core.experiment.build_engine`)."""
    return _build_engine(name, nk, nops)


def build_engines(nk=100_000, nops=30_000, names=None):
    """Engines with their default workloads, keyed by paper-facing name.

    The original three keep their paper aliases as keys (existing figures
    index by those); the newer engines use their canonical registry names.
    """
    if names is None:
        names = ("aerospike-like", "rocksdb-like", "cachelib-like",
                 "hash-index", "slab-cache")
    return {name: build_engine(name, nk, nops) for name in names}


def engine_trace(name, store, wl):
    """Trace + model params + the compiled trace (the sweep-ready source)."""
    tr = run_trace(store, wl)
    p = tr.op_params(store.times, P=12, T_sw=0.05 * US)
    return tr, p, tr.trace


# -- the device axis ---------------------------------------------------------

def device_config(n_ssd: int = 1, R_io: float = 0.0, B_io: float = 0.0,
                  L_switch_us: float = 0.0, **cfg_kw) -> SimConfig:
    """A :class:`SimConfig` for one device setup of the matrix.

    ``R_io``/``B_io`` are per-device rates; ``n_ssd > 1`` stripes IOs
    round-robin over per-device token clocks, and only a multi-device pool
    pays the CXL/PCIe switch fan-out hop ``L_switch_us`` per IO (a single
    direct-attached SSD has no switch to cross).
    """
    return SimConfig(n_ssd=n_ssd, R_io=R_io, B_io=B_io,
                     L_switch=L_switch_us * US if n_ssd > 1 else 0.0,
                     **cfg_kw)


def matrix_sweep(engine: str, n_ssd: int = 1, l_us_list=MATRIX_L_US,
                 candidates=N_CANDIDATES, nk: int = 100_000,
                 nops: int = 30_000, n_ops: int = 5000, seed: int = 7,
                 R_io: float = 250e3, L_switch_us: float = 0.3):
    """Latency-tolerance sweep of one (engine, device-count) matrix cell.

    Builds the equivalent :class:`~repro_torch.core.experiment.Scenario`
    (via :func:`default_scenario`) and runs it with the CLI's options, so
    its sweep points are those of
    ``Experiment(default_scenario(engine, n_ssd=n_ssd), run_options())``.
    Returns ``(trace_result, {l_us: SweepPoint})``.
    """
    sc = default_scenario(
        engine, n_ssd=n_ssd, latencies_us=tuple(l_us_list),
        thread_candidates=tuple(candidates), n_keys=nk, n_wl_ops=nops,
        n_ops=n_ops, seed=seed, R_io=R_io, L_switch_us=L_switch_us,
    )
    art = Experiment(sc, run_options()).run()
    return art.trace_result, dict(zip(l_us_list, art.points))
