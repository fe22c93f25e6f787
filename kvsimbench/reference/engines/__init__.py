"""Reference engines, one module each, found by the deployment's engine
name: ``get("hash-index")`` is ``engines/hash_index.py``'s ``Store``."""
from __future__ import annotations

import importlib


def get(name: str):
    """The ``Store`` class of engine ``name`` (dashes read as
    underscores)."""
    return importlib.import_module(
        f"{__name__}.{name.replace('-', '_')}").Store
