"""``BENCHMARK.json`` and the files it names, found by name.

A cell names a configuration (``configs/<name>.json``) and a traffic mix
(``traffic/<name>.json``); a per-layer metric is read by
``metrics/<name>.py``.  Nothing here needs an edit when a later change adds
any of them.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BENCHMARK = ROOT / "BENCHMARK.json"


def load() -> dict:
    return json.loads(BENCHMARK.read_text())


def config(name: str) -> dict:
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


def traffic(name: str) -> dict:
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


def cell(name: str) -> dict:
    """The cell ``name`` with its configuration, traffic and the metrics it
    reports (``end_to_end`` and ``per_layer`` entries that list it, or list
    no cells)."""
    doc = load()
    for w in doc["workloads"]:
        if w["name"] == name:
            break
    else:
        raise KeyError(f"no workload {name!r} in {BENCHMARK.name}; known: "
                       f"{[w['name'] for w in doc['workloads']]}")

    def mine(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]

    return dict(w, config_doc=config(w["config"]),
                traffic_doc=traffic(w["traffic"]),
                end_to_end=mine(doc["end_to_end"]),
                per_layer=mine(doc["per_layer"]))


def metric_reader(name: str):
    """The ``read(ctx)`` function of ``metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"kvsimbench.metrics:{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
