"""The control of ``correct``: the plain reference computed in float32, the
precision below the float64 the simulator states, put in the program's
place and judged by ``check.py``'s numbers.  It has to come out not
correct.

    python3 -m kvsimbench.control --workload <cell> --seeds 1,2,3 \\
        [--sweeps 400] [--processes 8]

prints one JSON line a seed: the control's ``trace_gap``, ``value_gap`` and
``count_gap`` against the float64 reference on the rows a run of
``--sweeps`` sweeps would sample, at the cell's own sizes.  It needs no
GPU: the reference is Python and NumPy.
"""
from __future__ import annotations

import argparse
import json
import sys
from concurrent.futures import ProcessPoolExecutor
from multiprocessing import get_context

import numpy as np

from . import bench, check, deployment


def control_numbers(inp: deployment.Inputs, n_sweeps: int) -> dict:
    """The control's numbers for a window of ``n_sweeps`` sweeps (the
    window's sweeps are numbered from 1)."""
    ref_tr, _ = check.reference_trace(inp)
    ctl_tr, _ = check.reference_trace(inp, np.float32)
    value, count = 0.0, 0
    for i, row in check.sample_rows(inp.seed, n_sweeps, len(inp.latencies)):
        got = check.reference_row(inp, ctl_tr, i + 1, row, np.float32)
        want = check.reference_row(inp, ref_tr, i + 1, row)
        count += check.reduction_faults(got, inp.threads)
        v, c = check.compare_row(got, 0, want)
        value = max(value, v)
        count += c
    got = {"trace_gap": check.trace_gap(ctl_tr, ref_tr), "value_gap": value,
           "count_gap": count}
    return {k: {"value": got[k], "limit": check.LIMITS[k]}
            for k in check.LIMITS}


def _one(args) -> dict:
    cell, seed, n_sweeps, overrides = args
    c = bench.cell(cell)
    inp = deployment.make(c["config_doc"], c["traffic_doc"], seed, overrides)
    numbers = control_numbers(inp, n_sweeps)
    return {"workload": cell, "seed": seed, "sweeps": n_sweeps,
            "correct": check.passed(numbers), "checks": numbers}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds")
    ap.add_argument("--sweeps", type=int, default=400,
                    help="sweeps of the window the sample is drawn from")
    ap.add_argument("--processes", type=int, default=1)
    args = ap.parse_args(argv)
    jobs = [(args.workload, int(s), args.sweeps, None)
            for s in args.seeds.split(",")]
    if args.processes > 1:
        with ProcessPoolExecutor(args.processes,
                                 mp_context=get_context("spawn")) as pool:
            rows = list(pool.map(_one, jobs))
    else:
        rows = [_one(j) for j in jobs]
    for r in rows:
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
