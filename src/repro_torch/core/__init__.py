"""Core of the port, in the reference's layers:

  * :mod:`repro_torch.core.engines`  -- pluggable KV-store engines (tree
    index / LSM / two-tier cache / hash index / slab cache) recording
    columnar suboperation traces
  * :mod:`repro_torch.core.trace_ir` -- the compiled columnar trace format
    shared by engines, simulator and model calibration
  * :mod:`repro_torch.core.sim`      -- the discrete-event simulator, plus
    the batched latency-sweep pipeline (``backend="torch"`` replays the
    whole grid on the device, ``backend="loop"`` on the host interpreter)
  * :mod:`repro_torch.core.latency_model` -- the paper's closed-form models,
    reused by the planner and the serving engine
  * :mod:`repro_torch.core.planner`, :mod:`repro_torch.core.tiering` --
    model-driven sizing of threads / prefetch depth, and the memory-tier
    descriptors (verbatim copies of the reference's modules)
  * :mod:`repro_torch.core.experiment`   -- the public entry point:
    declarative :class:`~repro_torch.core.experiment.Scenario` specs
    executed by :class:`~repro_torch.core.experiment.Experiment` into
    serializable :class:`~repro_torch.core.experiment.RunArtifact` tables
  * :mod:`repro_torch.core.cluster`      -- sharded fleets behind a router,
    one device grid per node
  * :mod:`repro_torch.core.conformance`  -- the backend contract table and
    the differential fuzzer that enforces it

``repro_torch.core.kvstore`` and ``repro_torch.core.simulator`` remain as
deprecation shims over the engines and sim packages.
"""
from . import (  # noqa: F401
    cluster,
    engines,
    experiment,
    latency_model,
    planner,
    sim,
    tiering,
    trace_ir,
    workloads,
)


def __getattr__(name):
    # Legacy attribute access (`repro_torch.core.kvstore` /
    # `repro_torch.core.simulator` after `import repro_torch.core`) keeps
    # working: resolve the deprecation shims lazily so their
    # DeprecationWarning only fires on actual use.
    if name in ("kvstore", "simulator", "conformance"):
        # conformance resolves lazily too, so `python -m
        # repro_torch.core.conformance` doesn't re-import its own main module.
        import importlib

        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
from .latency_model import (  # noqa: F401
    OpParams,
    SystemParams,
    cost_performance_ratio,
    theta_best_inv,
    theta_extended_inv,
    theta_mask_inv,
    theta_mem_inv,
    theta_multi_inv,
    theta_prob_inv,
    theta_single_inv,
)
from .sim import (  # noqa: F401
    CompiledTrace,
    Op,
    SimConfig,
    SimResult,
    simulate,
    simulate_compiled,
    sweep_latency,
)
from .experiment import (  # noqa: F401
    Experiment,
    RunArtifact,
    RunOptions,
    Scenario,
    default_scenario,
    run_scenario,
)
from .cluster import (  # noqa: F401
    ClusterSpec,
    sweep_cluster,
)
