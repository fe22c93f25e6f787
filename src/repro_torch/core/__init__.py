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

Cluster sweeps, the conformance fuzzer and the legacy shims of the
reference are not part of the port yet (``ROADMAP.md``).
"""
from . import (  # noqa: F401
    engines,
    experiment,
    latency_model,
    planner,
    sim,
    tiering,
    trace_ir,
    workloads,
)
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
