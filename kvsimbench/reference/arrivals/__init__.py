"""Open-loop arrival streams, one module per kind, found by name:
``get("poisson")(spec, n)`` gives ``n`` nondecreasing timestamps (s)."""
from __future__ import annotations

import importlib


def get(kind: str):
    return importlib.import_module(f"{__name__}.{kind}").generate
