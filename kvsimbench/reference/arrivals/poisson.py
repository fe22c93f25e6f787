"""Homogeneous Poisson arrivals at ``spec["rate"]`` ops/s, drawn from the
PCG64 stream of ``spec["seed"]``."""
from __future__ import annotations

import numpy as np


def generate(spec: dict, n: int) -> np.ndarray:
    rng = np.random.default_rng(spec["seed"])
    return np.cumsum(rng.exponential(1.0 / spec["rate"], n))
