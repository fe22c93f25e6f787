"""Roofline table from the port's dry-run artifacts.

Counterpart of ``benchmarks/roofline_table.py``: reads
``experiments/dryrun_torch/*.json`` (``python -m repro_torch.launch.dryrun``;
``DRYRUN_DIR`` overrides the directory), prints the three terms per cell,
flags the dominant bottleneck, and nominates the hillclimb candidates: the
worst roofline fraction, the most collective-bound, and the cell most
representative of the paper's technique (decode over the paged KV path).
Imports nothing of jax or the reference package.
"""
from __future__ import annotations

import glob
import json
import os

from .common_torch import emit

DRYRUN_DIR = os.environ.get("DRYRUN_DIR", "experiments/dryrun_torch")


def load_rows(mesh: str = "single") -> list[dict]:
    rows = []
    for path in sorted(glob.glob(os.path.join(DRYRUN_DIR, f"*__{mesh}.json"))):
        with open(path) as f:
            rows.append(json.load(f))
    return rows


def main() -> None:
    rows = load_rows("single")
    ok = [r for r in rows if r.get("status") == "ok"]
    for r in ok:
        name = f"roofline/{r['arch']}/{r['shape']}"
        dom = max(("t_compute", "t_memory", "t_collective"),
                  key=lambda k: r.get(k, 0.0))
        emit(name, r["t_compute"] * 1e6 if r.get("t_compute") else 0.0,
             f"t_mem_us={r.get('t_memory', 0)*1e6:.1f};"
             f"t_coll_us={r.get('t_collective', 0)*1e6:.1f};"
             f"bottleneck={r.get('bottleneck', dom)};"
             f"frac={r.get('roofline_fraction', 0):.3f};"
             f"useful={r.get('useful_ratio', 0):.3f};"
             f"GiB_dev={r.get('per_device_memory', 0)/2**30:.2f}")
    for r in rows:
        if r.get("status") == "skip":
            emit(f"roofline/{r['arch']}/{r['shape']}", 0.0, "SKIP")
        elif r.get("status") == "fail":
            emit(f"roofline/{r['arch']}/{r['shape']}", 0.0,
                 f"FAIL:{r.get('error', '?')[:60]}")
    if ok:
        worst = min(ok, key=lambda r: r.get("roofline_fraction", 1.0))
        coll = max(ok, key=lambda r: r.get("t_collective", 0.0)
                   / max(r.get("t_compute", 1e-12), 1e-12))
        emit("roofline/hillclimb/worst_fraction", 0.0,
             f"{worst['arch']}/{worst['shape']}")
        emit("roofline/hillclimb/most_collective_bound", 0.0,
             f"{coll['arch']}/{coll['shape']}")
        emit("roofline/hillclimb/paper_representative", 0.0,
             "qwen2.5-3b/decode_32k (paged-KV decode = the paper's technique)")


if __name__ == "__main__":
    main()
