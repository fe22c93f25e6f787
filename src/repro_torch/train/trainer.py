"""End-to-end training driver: data -> train_step -> checkpoint/FT.

Counterpart of ``repro/train/trainer.py``: the step run eagerly (no
``jit``) with the state donated by hand (:func:`.train_step.make_train_step`),
batches prefetched to ``device``.  ``device=None`` means the card and raises
without one; pass ``device="cpu"`` for the host.  Parameters are drawn by
``init_params`` from a ``torch.Generator`` on ``device`` seeded with
``seed``.

``mesh`` (a named ``DeviceMesh``, :mod:`repro_torch.launch.mesh`) shards
the run: every rank draws the whole parameters from the same seed, and the
state is placed as DTensors by ``state_shardings`` (moments take their
parameter's placements, ``count`` is replicated); each batch is placed by
``batch_shardings`` and the step runs under
``mesh_context(mesh, act_rules(mesh))``.  ``device`` is then the mesh's.
Every mesh starts from the weights of ``mesh=None``, and on a mesh of one
rank the run is bit-equal to it.  Checkpoints are gathered to the
reference's on-disk format (written by rank 0) and restored onto the mesh.
"""
from __future__ import annotations

import os
import tempfile
from dataclasses import dataclass, field

import torch

from ..core.sim.replay_torch import resolve_device
from ..data.pipeline import DataConfig, prefetch, synthetic_batches
from ..distributed.sharding import (NamedSharding, act_rules, batch_shardings,
                                    full, mesh_device, place_,
                                    state_shardings)
from ..models.layers import abstract_params, init_params, mesh_context
from ..zoo import get_api
from .checkpoint import CheckpointManager, latest_step, restore
from .ft import RestartableLoop
from .train_step import TrainHParams, init_train_state, make_train_step

__all__ = ["Trainer"]


def _default_ckpt_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "repro_ckpt")


@dataclass
class Trainer:
    cfg: object                     # ModelConfig
    hp: TrainHParams
    mesh: object | None = None
    ckpt_dir: str = field(default_factory=_default_ckpt_dir)
    ckpt_every: int = 50
    seed: int = 0

    def __post_init__(self):
        self.api = get_api(self.cfg)
        self.specs = self.api.param_specs(self.cfg)
        self._mdtype = (torch.bfloat16 if self.cfg.moment_dtype == "bfloat16"
                        else torch.float32)
        step = make_train_step(self.api, self.cfg, self.hp,
                               moment_dtype=self._mdtype)
        self.state_shardings = None
        if self.mesh is not None:
            if not hasattr(self.mesh, "mesh_dim_names"):
                raise TypeError(
                    "Trainer(mesh=...) takes a torch.distributed DeviceMesh "
                    "with named dims (repro_torch.launch.mesh."
                    f"make_local_mesh), not {type(self.mesh).__name__}")
            mesh = self.mesh
            self.device = mesh_device(mesh)
            rules = act_rules(mesh)
            p_shard = state_shardings(self.specs, mesh)
            self.state_shardings = {
                "params": p_shard,
                "opt": {"m": p_shard, "v": p_shard,
                        "count": NamedSharding(mesh, ())},
            }

            def wrapped(state, batch):
                batch = place_(dict(batch), batch_shardings(batch, mesh))
                with mesh_context(mesh, rules):
                    state, metrics = step(state, batch)
                return state, {k: full(v) for k, v in metrics.items()}

            self.train_step = wrapped
        else:
            self.device = resolve_device(self.device)
            self.train_step = step
        self.manager = CheckpointManager(self.ckpt_dir, every=self.ckpt_every)

    def init_state(self):
        gen = torch.Generator(self.device).manual_seed(self.seed)
        state = init_train_state(init_params(self.specs, gen), self.hp,
                                 self._mdtype)
        if self.state_shardings is not None:
            place_(state, self.state_shardings)
        return state

    def _like(self):
        """The state's tree of ``meta`` tensors: shapes and dtypes only."""
        return init_train_state(abstract_params(self.specs), self.hp,
                                self._mdtype)

    def _restore(self, step: int):
        return restore(self.ckpt_dir, step, self._like(), device=self.device,
                       shardings=self.state_shardings)

    def data_iter(self, start_step: int = 0, batch_override: int | None = None):
        dcfg = DataConfig(
            global_batch=batch_override or self.hp_global_batch,
            seq_len=self.hp_seq_len,
            vocab=self.cfg.vocab,
            seed=self.seed,
        )
        return prefetch(synthetic_batches(dcfg, start_step),
                        device=self.device)

    hp_global_batch: int = 8
    hp_seq_len: int = 128
    device: object = None           # None: the card; "cpu" for the host

    def fit(self, n_steps: int, resume: bool = True):
        last = latest_step(self.ckpt_dir) if resume else None
        start = 0
        if last is not None:
            state = self._restore(last)
            start = last
        else:
            state = self.init_state()

        loop = RestartableLoop(
            self.train_step, self.manager,
            lambda s: self.data_iter(s), max_restarts=3,
        )
        state, end = loop.run(state, n_steps, start_step=start,
                              restore_fn=self._restore)
        self.manager.maybe_save(end, state, force=True)
        self.manager.wait()
        return state, loop.metrics_log
