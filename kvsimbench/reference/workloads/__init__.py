"""Key-stream generators, one module each, found by name:
``get("zipf")(n_keys, n_ops, seed=..., **kwargs) -> (keys, is_write)``."""
from __future__ import annotations

import importlib

import numpy as np


def get(name: str):
    return importlib.import_module(
        f"{__name__}.{name.replace('-', '_')}").generate


def write_mask(n_ops: int, read_write, rng: np.random.Generator):
    """Which ops write, for a ``(reads, writes)`` ratio."""
    r, w = read_write
    if w == 0:
        return np.zeros(n_ops, dtype=bool)
    return rng.random(n_ops) < (w / (r + w))
