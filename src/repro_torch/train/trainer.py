"""End-to-end training driver: data -> train_step -> checkpoint/FT.

Counterpart of ``repro/train/trainer.py`` for ``mesh=None``: one device, the
step run eagerly (no ``jit``) with the state donated by hand
(:func:`.train_step.make_train_step`), batches prefetched to ``device``.
``device=None`` means the card and raises without one; pass
``device="cpu"`` for the host.  Parameters are drawn by ``init_params``
from a ``torch.Generator`` on ``device`` seeded with ``seed``.
"""
from __future__ import annotations

import os
import tempfile
from dataclasses import dataclass, field

import torch

from ..core.sim.replay_torch import resolve_device
from ..data.pipeline import DataConfig, prefetch, synthetic_batches
from ..models.layers import init_params, map_tree
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
        if self.mesh is not None:
            raise NotImplementedError(
                "Trainer(mesh=...): sharded training needs the port's "
                "distribution layer (distributed/sharding.py, ROADMAP.md "
                "A16), which is not ported yet; pass mesh=None")
        self.device = resolve_device(self.device)
        self.api = get_api(self.cfg)
        self.specs = self.api.param_specs(self.cfg)
        self._mdtype = (torch.bfloat16 if self.cfg.moment_dtype == "bfloat16"
                        else torch.float32)
        self.train_step = make_train_step(self.api, self.cfg, self.hp,
                                          moment_dtype=self._mdtype)
        self.manager = CheckpointManager(self.ckpt_dir, every=self.ckpt_every)

    def init_state(self):
        gen = torch.Generator(self.device).manual_seed(self.seed)
        params = init_params(self.specs, gen)
        return init_train_state(params, self.hp, self._mdtype)

    def _like(self):
        """The state's tree of ``meta`` tensors: shapes and dtypes only."""
        meta = map_tree(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                              device="meta"), self.specs)
        return init_train_state(meta, self.hp, self._mdtype)

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
            state = restore(self.ckpt_dir, last, self._like(),
                            device=self.device)
            start = last
        else:
            state = self.init_state()

        def restore_fn(step):
            return restore(self.ckpt_dir, step, self._like(),
                           device=self.device)

        loop = RestartableLoop(
            self.train_step, self.manager,
            lambda s: self.data_iter(s), max_restarts=3,
        )
        state, end = loop.run(state, n_steps, start_step=start,
                              restore_fn=restore_fn)
        self.manager.maybe_save(end, state, force=True)
        self.manager.wait()
        return state, loop.metrics_log
