"""The inputs of one run, made from the configuration, the traffic mix and
``--seed``, the same for the program and the reference.

Every seed of a run is drawn from ``--seed`` (``numpy.random.SeedSequence``):
the engine's bulk-load order, the key stream, and per sweep ``k`` of the
window the scheduler's draws and the arrival stream.  The files fix sizes
and settings only.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .reference import workloads

US = 1e-6

# SimConfig fields a configuration may set, in seconds or plain units,
# with their defaults (the simulator's own).  ``*_us`` keys of the
# configuration's "sim" block are microseconds.
SIM_DEFAULTS = dict(
    n_cores=1, T_sw=0.05 * US, P=12, rho=1.0, L_dram=0.1 * US, eps=0.0,
    A_mem=64.0, B_mem=0.0, L_io=80.0 * US, L_io_jitter=0.25, A_io=1024.0,
    B_io=0.0, R_io=0.0, n_ssd=1, L_switch=0.0, io_degrade=1.0,
    T_degrade=0.0, T_lock=0.0)


def _seed(seed: int, *path: int) -> int:
    """A 63-bit seed drawn from ``seed`` for the purpose ``path``."""
    state = np.random.SeedSequence([int(seed), *path]).generate_state(
        2, np.uint32)
    return (int(state[0]) << 31) | (int(state[1]) >> 1)


@dataclass(frozen=True)
class Inputs:
    """One run's inputs.  ``sim`` is in seconds; ``latencies`` too."""

    config: dict
    traffic: dict
    seed: int
    keys: np.ndarray
    is_write: np.ndarray
    engine_kwargs: dict
    sim: dict
    latencies: list
    threads: list
    n_ops: int
    arrival: dict | None          # spec of sweep 0; ``arrival_for(k)``

    def sweep_seed(self, k: int) -> int:
        """The scheduler's seed (``SimConfig.seed``) of sweep ``k``."""
        return _seed(self.seed, 3, k)

    def arrival_for(self, k: int) -> dict | None:
        if self.arrival is None:
            return None
        return dict(self.arrival, seed=_seed(self.seed, 4, k))

    def arrival_count(self) -> int:
        """Timestamps an open-loop sweep draws: the widest cell's start-up
        threads, warm-up and measured ops, plus one."""
        n_cores = self.sim["n_cores"]
        return max(n_cores * c + 2 * c * n_cores + self.n_ops
                   for c in self.threads) + 1


def latency_axis(spec) -> list:
    """Latencies in seconds from the traffic's ``latencies_us``: a list, or
    ``{"linspace": [lo, hi, n], "round": digits}``."""
    if isinstance(spec, dict):
        lo, hi, n = spec["linspace"]
        us = np.round(np.linspace(lo, hi, int(n)), spec.get("round", 4))
    else:
        us = np.asarray(spec, dtype=np.float64)
    return [float(x) * US for x in us]


def make(config: dict, traffic: dict, seed: int,
         overrides: dict | None = None) -> Inputs:
    """The run's inputs; ``overrides`` replaces top-level keys of the
    configuration and the traffic (the tests' small sizes)."""
    config = dict(config, **(overrides or {}).get("config", {}))
    traffic = dict(traffic, **(overrides or {}).get("traffic", {}))
    keys, is_write = workloads.get(config["workload"])(
        config["n_keys"], config["n_wl_ops"], seed=_seed(seed, 1),
        **config.get("workload_kwargs", {}))
    engine_kwargs = dict(config.get("engine_kwargs", {}))
    if config.get("engine_seed_kwarg"):
        engine_kwargs[config["engine_seed_kwarg"]] = _seed(seed, 2)
    sim = dict(SIM_DEFAULTS)
    for k, v in config["sim"].items():
        if k.endswith("_us"):
            sim[k[:-3]] = float(v) * US
        else:
            sim[k] = v
    unknown = set(sim) - set(SIM_DEFAULTS)
    if unknown:
        raise ValueError(f"unknown simulator settings {sorted(unknown)}")
    arrival = None
    if traffic.get("arrival"):
        a = traffic["arrival"]
        rate = a["load"] * config["capacity_ops_per_s"]
        arrival = {"kind": a["kind"], "rate": float(rate),
                   "seed": _seed(seed, 4, 0),
                   "deadline": float(a.get("deadline_s", 0.0))}
    return Inputs(config=config, traffic=traffic, seed=int(seed), keys=keys,
                  is_write=is_write, engine_kwargs=engine_kwargs, sim=sim,
                  latencies=latency_axis(traffic["latencies_us"]),
                  threads=[int(t) for t in traffic["threads"]],
                  n_ops=int(traffic["n_ops"]), arrival=arrival)
