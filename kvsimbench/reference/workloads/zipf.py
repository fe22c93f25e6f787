"""Bounded Zipf keys, P(rank r) ~ r**-exponent, ranks scattered over the key
space by a multiplicative hash (YCSB ``requestdistribution=zipfian``)."""
from __future__ import annotations

import numpy as np

from . import write_mask


def generate(n_keys: int, n_ops: int, exponent: float = 0.99,
             read_write=(1, 0), seed: int = 0):
    rng = np.random.default_rng(seed)
    pmf = np.arange(1, n_keys + 1, dtype=np.float64) ** (-exponent)
    cdf = np.cumsum(pmf)
    cdf /= cdf[-1]
    ranks = np.searchsorted(cdf, rng.random(n_ops))
    keys = (ranks.astype(np.uint64) * np.uint64(2654435761)) % np.uint64(n_keys)
    return keys.astype(np.int64), write_mask(n_ops, read_write, rng)
