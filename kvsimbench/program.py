"""The program under test, ``repro_torch`` (the PyTorch / CUDA port): the
calls a run makes into it, and nothing else of it.

Set-up builds the deployment's engine and replays the workload through it
(``core.engines.run_trace``, host Python); the window calls
``core.sim.sweep_latency(backend="torch")``, which plans the grid
(``replay_torch.plan_grid``) and steps every cell with the fused scheduler
kernel (``kernels.sched_step.fused_steps_group`` -> ``csrc/sched_step.cu``).
"""
from __future__ import annotations

import dataclasses

from .deployment import Inputs


def build_trace(inp: Inputs):
    """The engine walk: the program's engine, fed the benchmark's keys."""
    from repro_torch.core.engines import get_engine, run_trace
    from repro_torch.core.workloads import Workload

    store = get_engine(inp.config["engine"])(inp.config["n_keys"],
                                             **inp.engine_kwargs)
    wl = Workload(inp.config["workload"], inp.keys, inp.is_write,
                  inp.config["n_keys"])
    return run_trace(store, wl, inp.config["warmup_frac"])


class Sweeper:
    """One cell's sweep, ready to call: ``sweep(k)`` runs sweep ``k`` of
    the window (its own scheduler and arrival seeds) and returns the
    points, one a latency."""

    def __init__(self, inp: Inputs, trace, device):
        from repro_torch.core.sim import SimConfig, sweep_latency

        self.inp = inp
        self.trace = trace
        self.device = device
        self.cfg = SimConfig(**inp.sim)
        self.collect = bool(inp.traffic.get("collect_percentiles", False))
        self._sweep = sweep_latency

    def sweep(self, k: int):
        inp = self.inp
        return self._sweep(
            dataclasses.replace(self.cfg, seed=inp.sweep_seed(k)),
            self.trace, inp.latencies, inp.threads, n_ops=inp.n_ops,
            backend="torch", device=self.device, cache_dir=None,
            arrival=inp.arrival_for(k), collect_percentiles=self.collect)

    def plan(self, k: int):
        """``replay_torch.plan_grid`` on sweep ``k``'s grid, as
        ``sweep_latency`` calls it (the arrival stream drawn first)."""
        from repro_torch.core.sim import generate_arrivals
        from repro_torch.core.sim.replay_torch import plan_grid

        inp = self.inp
        spec = inp.arrival_for(k)
        arrivals = (generate_arrivals(spec, inp.arrival_count())
                    if spec is not None else None)
        return lambda: plan_grid(
            dataclasses.replace(self.cfg, seed=inp.sweep_seed(k)),
            self.trace, inp.latencies, inp.threads, inp.n_ops,
            device=self.device, arrivals=arrivals,
            collect_percentiles=self.collect,
            deadline=spec["deadline"] if spec else 0.0)
