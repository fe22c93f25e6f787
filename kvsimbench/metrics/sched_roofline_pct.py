"""Share of the fused scheduler kernel's roofline: the least time the
sweep's scheduling could take on the card's memory system, over the
kernel's device time per sweep (``sched_kernel_ms``).

The bytes are counted from the trace and the grid, not from the kernel,
so any kernel is held to the same work.  Each cell of the grid (latency x
threads ``T``) executes its ``2 T`` warm-up and ``n_ops`` measured ops:

* their suboperation records, each read once: kind and CPU time (2 x 8
  bytes) a suboperation, at the trace's mean suboperations per op, and the
  op's bounds (2 x 8 bytes) an op;
* the uniforms those suboperations consume, 8 bytes each, ``n_u`` a
  suboperation (one for the IO jitter, two for re-fetches, one for a DRAM
  tier);
* the cell's state planes, read once and written once: clocks and
  counters, ``T`` threads' ring, wake, prefetch and span entries, ``P``
  prefetch slots, two token clocks per SSD, and (open loop) the 512-bin
  sojourn histogram.

No operation count is given: the step is comparisons and adds, far below
the card's float64 rate.  The bound is bytes over the published HBM rate
of one H100 SXM, 3.35 TB/s.
"""

HBM_BYTES_PER_S = 3.35e12
HIST_BINS = 512


def sweep_bytes(trace_ops: int, trace_subops: int, latencies: int,
                threads, n_ops: int, sim: dict, collect: bool) -> float:
    n_u = 2 * (sim["eps"] > 0) + (sim["L_io_jitter"] > 0) + (sim["rho"] < 1)
    per_op = trace_subops / trace_ops
    total = 0.0
    for T in threads:
        ops = 2 * T * sim["n_cores"] + n_ops
        records = ops * per_op * (16 + 8 * n_u) + ops * 16
        state = 6 * 8 + (7 if collect else 6) * 4
        state += T * sim["n_cores"] * (2 + (3 if collect else 2)) * 8
        state += sim["P"] * sim["n_cores"] * 8
        if sim["R_io"] > 0 or sim["B_io"] > 0:
            state += 2 * sim["n_ssd"] * 8
        if collect:
            state += (HIST_BINS + 1) * 8
        total += latencies * (records + 2 * state)
    return total


def read(ctx):
    dt = ctx["dtrace"]
    if dt is None:
        return None
    kernel_s = dt.device_seconds("sched_step_kernel") / dt.n_sweeps
    if kernel_s <= 0:
        return None
    inp, tr = ctx["inputs"], ctx["trace"]
    b = sweep_bytes(tr.n_ops, tr.n_subops, len(inp.latencies), inp.threads,
                    inp.n_ops, inp.sim,
                    bool(inp.traffic.get("collect_percentiles", False)))
    return 100.0 * (b / HBM_BYTES_PER_S) / kernel_s
