"""Assemble the dry-run and roofline tables from the dry-run artifacts.

Counterpart of ``repro/launch/report.py``: ``python -m
repro_torch.launch.report [single|multi]`` prints the dry-run and roofline
tables, with the reference's columns, from ``experiments/dryrun_torch/*.json``
(written by :mod:`.dryrun`).
"""
from __future__ import annotations

import glob
import json
import os
import sys

DIR = "experiments/dryrun_torch"


def load(mesh: str, policy: str | None = None) -> list[dict]:
    rows = []
    for p in sorted(glob.glob(os.path.join(DIR, f"*__{mesh}*.json"))):
        base = os.path.basename(p)[: -len(".json")]
        parts = base.split("__")
        pol = parts[3] if len(parts) > 3 else "baseline"
        if policy is not None and pol != policy:
            continue
        with open(p) as f:
            r = json.load(f)
        r["policy"] = r.get("policy", pol)
        rows.append(r)
    return rows


def fmt_bytes(b: float) -> str:
    return f"{b / 2**30:.2f}"


def dryrun_table(mesh: str) -> str:
    rows = load(mesh, "baseline")
    out = [
        f"| arch | shape | status | GiB/dev | HLO GFLOPs (global) | "
        f"coll GiB/chip | collective mix |",
        "|---|---|---|---|---|---|---|",
    ]
    for r in sorted(rows, key=lambda r: (r["arch"], r["shape"])):
        if r.get("status") == "ok":
            mix = r.get("coll_counts", {})
            mixs = " ".join(f"{k.split('-')[-1]}:{v}" for k, v in mix.items() if v)
            out.append(
                f"| {r['arch']} | {r['shape']} | ok | "
                f"{fmt_bytes(r.get('per_device_memory', 0))} | "
                f"{r.get('hlo_flops', 0) / 1e9:.0f} | "
                f"{r.get('coll_bytes_link', 0) / 2**30:.2f} | {mixs} |"
            )
        elif r.get("status") == "skip":
            out.append(f"| {r['arch']} | {r['shape']} | SKIP | - | - | - | "
                       f"{r.get('reason', '')[:60]} |")
        else:
            out.append(f"| {r['arch']} | {r['shape']} | FAIL | - | - | - | "
                       f"{r.get('error', '')[:60]} |")
    return "\n".join(out)


def roofline_table(mesh: str) -> str:
    rows = [r for r in load(mesh, "baseline") if r.get("status") == "ok"]
    out = [
        "| arch | shape | t_comp ms | t_mem ms | t_coll ms | bottleneck | "
        "roofline frac | MODEL/HLO flops |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for r in sorted(rows, key=lambda r: (r["arch"], r["shape"])):
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['t_compute'] * 1e3:.2f} | "
            f"{r['t_memory'] * 1e3:.2f} | {r['t_collective'] * 1e3:.2f} | "
            f"{r['bottleneck']} | {r['roofline_fraction']:.3f} | "
            f"{r['useful_ratio']:.3f} |"
        )
    return "\n".join(out)


def main() -> None:
    mesh = sys.argv[1] if len(sys.argv) > 1 else "single"
    print(f"### Dry-run ({mesh}-pod)\n")
    print(dryrun_table(mesh))
    print(f"\n### Roofline ({mesh}-pod)\n")
    print(roofline_table(mesh))


if __name__ == "__main__":
    main()
