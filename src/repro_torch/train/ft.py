"""Fault tolerance: restartable training, straggler detection, elastic remesh.

Counterpart of ``repro/train/ft.py``, whose two classes are numpy code: the
port keeps its own verbatim copy of them.  At thousand-node scale the
assumptions are: (1) some host *will* fail mid-run -- recovery is
restore-latest + replay, (2) some host will run slow before it fails --
detect via step-time outliers and flag for eviction, (3) the replacement
pool may change the world size -- checkpoints are mesh-agnostic, so the same
state restores onto a resized mesh (:func:`elastic_restore`).  In one
process the multi-host signals are simulated (tests inject
failures/delays); the logic is the deployable part.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np

__all__ = ["StragglerDetector", "RestartableLoop", "elastic_restore"]


@dataclass
class StragglerDetector:
    """Per-host step-time ring; flags hosts slower than k x median.

    On a real deployment each host contributes its step wall-time through a
    tiny all-gather (or the coordinator service); here ``observe`` takes the
    vector directly.
    """

    n_hosts: int
    window: int = 16
    threshold: float = 2.0
    grace_steps: int = 3
    _times: list[deque] = field(default_factory=list)
    _strikes: np.ndarray | None = None

    def __post_init__(self):
        self._times = [deque(maxlen=self.window) for _ in range(self.n_hosts)]
        self._strikes = np.zeros(self.n_hosts, np.int32)

    def observe(self, step_times: np.ndarray) -> list[int]:
        """Returns host ids that have been slow for ``grace_steps`` steps."""
        for h, t in enumerate(step_times):
            self._times[h].append(float(t))
        med = np.median([np.median(q) for q in self._times if q])
        slow = np.array(
            [bool(q) and np.median(q) > self.threshold * med for q in self._times]
        )
        self._strikes = np.where(slow, self._strikes + 1, 0)
        return [int(h) for h in np.nonzero(self._strikes >= self.grace_steps)[0]]


class RestartableLoop:
    """Run a step function with checkpoint/restart semantics.

    ``step_fn(state, batch) -> (state, metrics)`` may raise (preemption,
    device loss, injected test failures); the loop restores the latest
    checkpoint and replays from there, up to ``max_restarts``.
    """

    def __init__(self, step_fn, manager, data_iter_fn, *, max_restarts: int = 3):
        self.step_fn = step_fn
        self.manager = manager
        self.data_iter_fn = data_iter_fn   # (start_step) -> iterator of batches
        self.max_restarts = max_restarts
        self.restarts = 0
        self.metrics_log: list[dict] = []

    def run(self, state, n_steps: int, start_step: int = 0,
            restore_fn=None):
        step = start_step
        data = self.data_iter_fn(step)
        while step < n_steps:
            try:
                batch = next(data)
                t0 = time.time()
                state, metrics = self.step_fn(state, batch)
                metrics = dict(metrics) if isinstance(metrics, dict) else {}
                metrics["wall"] = time.time() - t0
                metrics["restarts"] = self.restarts
                self.metrics_log.append(metrics)
                step += 1
                self.manager.maybe_save(step, state)
            except Exception:  # noqa: BLE001 -- any failure triggers recovery
                self.restarts += 1
                if self.restarts > self.max_restarts or restore_fn is None:
                    raise
                from .checkpoint import latest_step

                last = latest_step(self.manager.dir)
                if last is None:
                    raise
                state = restore_fn(last)
                step = last
                data = self.data_iter_fn(step)   # deterministic replay point
        self.manager.wait()
        return state, step


def elastic_restore(ckpt_dir: str, step: int, like, new_mesh, specs,
                    fsdp: bool = True):
    """Restore a checkpoint onto a *different* mesh (elastic scaling).

    ``specs`` is the ParamSpec tree; shardings are re-derived from the new
    mesh's named axes, so nothing about the checkpoint depends on the world
    size it was written at.
    """
    from ..distributed.sharding import state_shardings
    from .checkpoint import restore

    shard = state_shardings(specs, new_mesh, fsdp)
    return restore(ckpt_dir, step, like["params"] if "params" in like else like,
                   shardings=shard)
