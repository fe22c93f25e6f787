"""Uniform keys over ``[0, n_keys)`` (YCSB ``requestdistribution=uniform``)."""
from __future__ import annotations

import numpy as np

from . import write_mask


def generate(n_keys: int, n_ops: int, read_write=(1, 0), seed: int = 0):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, n_keys, n_ops)
    return keys, write_mask(n_ops, read_write, rng)
