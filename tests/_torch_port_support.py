"""Shared helpers of the ``test_torch_*`` files: the same seeded inputs for
the JAX reference (``repro``) and the PyTorch port (``repro_torch``)."""
import numpy as np

from repro.core import workloads as ref_workloads
from repro.core.engines import available_engines as ref_engines
from repro.core.engines import run_trace as ref_run_trace
from repro.core.experiment import default_scenario as ref_default_scenario

from repro_torch.core import workloads as port_workloads
from repro_torch.core.engines import available_engines as port_engines
from repro_torch.core.engines import run_trace as port_run_trace
from repro_torch.core.experiment import (
    default_scenario as port_default_scenario,
)

US = 1e-6

#: ``compile(compiler_options=...)`` for the reference's jitted programs: at
#: the default level XLA-CPU contracts ``a*b+c`` into fused multiply-adds;
#: level 0 keeps every operation IEEE, bit-equal to op-by-op execution.
XLA_NO_FMA = {"xla_backend_optimization_level": 0}

ENGINES = sorted({cls.engine_name for cls in ref_engines().values()})


def engine_trace(engine, n_keys=2_000, n_wl_ops=600, port=True):
    """The engine's default-pairing trace (``TraceResult``) from the port
    (``port=True``) or from the reference package."""
    if port:
        default, engines, wls, run = (port_default_scenario, port_engines,
                                      port_workloads, port_run_trace)
    else:
        default, engines, wls, run = (ref_default_scenario, ref_engines,
                                      ref_workloads, ref_run_trace)
    sc = default(engine, n_keys=n_keys, n_wl_ops=n_wl_ops)
    store = engines()[engine](sc.n_keys, **sc.engine_kwargs)
    wname, wkw = sc.resolved_workload()
    wl = wls.create_workload(wname, sc.n_keys, sc.n_wl_ops, **wkw)
    return run(store, wl)


def bits_equal(a, b):
    """Bit-for-bit equality of two arrays (floats by pattern, so ``-0.0``
    differs from ``0.0`` and infinities compare)."""
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape:
        return False
    if a.dtype.kind == "f" or b.dtype.kind == "f":
        return np.array_equal(a.astype(np.float64).view(np.int64),
                              b.astype(np.float64).view(np.int64))
    return np.array_equal(a.astype(np.int64), b.astype(np.int64))
