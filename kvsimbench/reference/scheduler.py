"""One grid cell of the virtual-time scheduler as a plain event loop.

A cell is one ``(memory latency L, threads T)`` point of a sweep: ``T``
user-level threads on one core replay the cyclic trace, each op a run of
suboperations.  One loop iteration ("step") executes one suboperation of
one thread:

1. Pick the thread: the earliest entry of the ready queue.  A thread that
   yielded re-enters it keyed by the time it was picked; a thread parked on
   an IO or on an arrival joins it keyed by its wake time once that time
   has come.  With none ready, time jumps to the earliest wake.  Keys are
   compared at a resolution of ``2**8`` float64 ulps, equal keys by thread
   id (the scheduler's stated tie rule).
2. MEM waits for the thread's outstanding prefetch; then the
   suboperation's CPU time passes.
3. The op's last suboperation completes the op: the warm-up count, the
   measured count, the sojourn (open loop) and the next op from the shared
   trace cursor.
4. PREIO (not last in its op) submits an IO to SSD ``round robin``, gated
   by the device's IOPS / bandwidth token clocks; it completes after
   ``L_io`` (with its jitter) and the switch hop, and the thread parks.
5. The next suboperation's prefetch (if it is MEM) takes the earliest of
   the ``P`` prefetch slots, starts when both it and the thread are free,
   and completes after ``L``.
6. The context switch ``T_sw`` passes; the thread re-queues or parks.

The cell stops once ``n_ops`` ops after the ``2 T`` warm-up ops have
completed.  ``real`` is the arithmetic type of every time value: ``float``
(float64, what the deployment states) or ``numpy.float32`` (the control).
"""
from __future__ import annotations

import heapq
import math
import struct
from dataclasses import dataclass

import numpy as np

from .draws import CellDraws
from .trace import MEM, PREIO

EPOCH = float(np.finfo(np.float64).tiny)
HIST_LO = 1e-7
HIST_BINS = 512
HIST_RATIO = 10.0 ** (1.0 / 64)
HIST_INV_LN_RATIO = 64 / math.log(10.0)
QUANTILES = (0.5, 0.9, 0.99)

_PACK = struct.Struct("<d").pack
_UNPACK = struct.Struct("<q").unpack


def order(t: float) -> int:
    """A non-negative time's ordering key: its float64 bits without the
    low 8."""
    return _UNPACK(_PACK(float(t)))[0] >> 8


@dataclass
class Cell:
    throughput: float
    time: float
    mem_stall_total: float
    mem_accesses: int
    hist: list | None = None       # sojourn counts (open loop)
    lat_max: float = math.nan
    missed: int = 0

    def summary(self) -> dict | None:
        """p50 / p90 / p99 (bin midpoints, nearest rank), max, count,
        missed -- or ``None`` without a histogram."""
        if self.hist is None:
            return None
        cum = np.cumsum(np.asarray(self.hist, dtype=np.float64))
        total = int(cum[-1])
        out = {"count": total, "max": self.lat_max if total else math.nan,
               "missed": self.missed}
        for q in QUANTILES:
            rank = math.ceil(q * max(total, 1))
            b = min(int((cum < rank).sum()), HIST_BINS - 1)
            out[f"p{round(q * 100)}"] = (HIST_LO * HIST_RATIO ** (b + 0.5)
                                         if total else math.nan)
        return out


def run_cell(trace, sim: dict, latency: float, threads: int, n_ops: int,
             seed: int, arrivals=None, collect: bool = False,
             real=float) -> Cell:
    """Replay one grid cell.  ``sim`` holds the device settings in seconds
    (``T_sw``, ``P``, ``L_io``, ``L_io_jitter``, ``n_ssd``, ``R_io``,
    ``B_io``, ``A_io``, ``L_switch``, ``eps``, ``rho``, ``L_dram``,
    ``B_mem``, ``A_mem``, ``T_lock``, ``io_degrade``, ``T_degrade``,
    ``deadline``); ``arrivals`` switches the cell to the open loop;
    ``collect`` keeps the sojourn histogram."""
    if sim.get("n_cores", 1) != 1:
        raise NotImplementedError("the reference replays one core")
    r = real
    zero = r(0.0)
    one, two = r(1.0), r(2.0)
    inf = math.inf
    kinds = trace.kinds.tolist()
    durs = [r(d) for d in trace.durs.tolist()]
    starts = trace.bounds[:-1].tolist()
    ends = trace.bounds[1:].tolist()
    n_trace = len(starts)
    T = int(threads)
    warm = 2 * T
    P = int(sim["P"])
    L = r(latency)
    T_sw = r(sim["T_sw"])
    eps, rho = float(sim["eps"]), float(sim["rho"])
    L_dram = r(sim["L_dram"])
    L_io = r(sim["L_io"])
    L_io_deg = r(float(sim["L_io"]) * float(sim["io_degrade"]))
    has_degrade = float(sim["io_degrade"]) != 1.0
    T_degrade = r(sim["T_degrade"])
    jitter = r(sim["L_io_jitter"])
    S = int(sim["n_ssd"])
    inv_R = r(1.0 / sim["R_io"]) if sim["R_io"] > 0.0 else None
    cost_bw = r(sim["A_io"] / sim["B_io"]) if sim["B_io"] > 0.0 else None
    L_switch = r(sim["L_switch"])
    cost_bmem = r(sim["A_mem"] / sim["B_mem"]) if sim["B_mem"] > 0.0 else None
    T_lock = r(sim["T_lock"])
    deadline = float(sim.get("deadline", 0.0))
    open_loop = arrivals is not None
    arr = [r(a) for a in np.asarray(arrivals).tolist()] if open_loop else []
    n_arr = len(arr)

    # uniforms of one step: eps (2), jitter, rho -- in this order
    j_eps = 0 if eps > 0.0 else None
    j_jit = (2 if eps > 0.0 else 0) if float(jitter) > 0.0 else None
    j_rho = ((2 if eps > 0.0 else 0) + (float(jitter) > 0.0)
             if rho < 1.0 else None)
    draws = CellDraws(seed, latency, T)

    def lmem(u):
        return L_dram if (rho < 1.0 and u >= rho) else L

    # -- start-up: consecutive trace slots from a drawn cursor -------------
    cursor0 = math.floor(draws.cursor() * n_trace)
    cursor = (cursor0 + T) % n_trace
    pf = [zero] * T            # the thread's outstanding prefetch
    at = [0] * T               # its next suboperation
    end = [0] * T              # the end of its op
    op_start = [zero] * T      # its op's arrival (sojourn start)
    ready: list = []           # (order key, tid)
    parked: list = []          # (wake, tid)
    thr_ready_key = max(T * EPOCH, 0.0)
    for t in range(T):
        op = (cursor0 + t) % n_trace
        at[t], end[t] = starts[op], ends[op]
        lm = L_dram if (rho < 1.0 and draws.thread(t, 1) >= rho) else L
        pf[t] = r(draws.thread(t, 0)) * lm
        a0 = arr[min(t, n_arr - 1)] if open_loop else zero
        if open_loop:
            pf[t] = pf[t] + a0
            op_start[t] = a0
        if open_loop and a0 > 0.0:
            heapq.heappush(parked, (a0, t))
        else:
            heapq.heappush(ready, (order(t * EPOCH), t))
    slots = [r(k * EPOCH) for k in range(P)]
    tok = [zero] * S
    bw = [zero] * S
    io_rr = 0
    now = zero
    pf_bw = zero
    lock = zero
    t_start = None
    done = counted = mem_acc = missed = 0
    measuring = warm <= 0
    stall_total = zero
    hist = [0] * HIST_BINS if collect else None
    lat_max = -inf
    step = 0

    while counted < n_ops:
        # 1. pick the thread
        while parked and parked[0][0] <= now:
            w, t = heapq.heappop(parked)
            heapq.heappush(ready, (order(max(w, thr_ready_key)), t))
        if not ready:
            now = max(now, parked[0][0])
            continue
        _, tid = heapq.heappop(ready)
        pop_now = now
        i, e = at[tid], end[tid]
        kind, dur = kinds[i], durs[i]
        # 2. MEM stall, then the CPU time
        ready_at = pf[tid]
        if j_eps is not None and draws.step(step, j_eps) < eps:
            ready_at = now + lmem(draws.step(step, j_eps + 1))
        is_mem = kind == MEM
        stall = ready_at - now
        stalled = is_mem and stall > 0.0
        if measuring:
            if stalled:
                stall_total = stall_total + stall
            mem_acc += is_mem
        now = (ready_at if stalled else now) + dur
        # 3. op completion
        eoo = i + 1 >= e
        if eoo:
            if open_loop:
                arr_next = arr[min(T + done, n_arr - 1)]
            done += 1
            if done >= warm:
                measuring = True
                counted += 1
                if t_start is None:
                    t_start = now
                if collect:
                    sojourn = now - op_start[tid]
                    if deadline > 0.0 and sojourn > deadline:
                        missed += 1
                    else:
                        b = math.floor(math.log(max(float(sojourn), HIST_LO)
                                                / HIST_LO) * HIST_INV_LN_RATIO)
                        hist[min(max(b, 0), HIST_BINS - 1)] += 1
                        lat_max = max(lat_max, float(sojourn))
            op_start[tid] = arr_next if open_loop else now
            at[tid], end[tid] = starts[cursor], ends[cursor]
            cursor = (cursor + 1) % n_trace
            if T_lock > 0.0:
                now = max(now, lock) + T_lock
                lock = now
        else:
            at[tid] = i + 1
        # 4. IO submission
        park = kind == PREIO and not eoo
        if park:
            d = io_rr % S
            svc = now
            if inv_R is not None:
                svc = max(svc, tok[d])
                tok[d] = svc + inv_R
            if cost_bw is not None:
                svc = max(svc, bw[d])
                bw[d] = svc + cost_bw
            if S > 1:
                io_rr += 1
            lat_io = L_io_deg if (has_degrade and now >= T_degrade) else L_io
            if j_jit is not None:
                u = r(draws.step(step, j_jit))
                lat_io = lat_io * (one + jitter * (two * u - one))
            park_until = svc + lat_io + L_switch
        # 5. the next suboperation's prefetch
        if kinds[at[tid]] == MEM:
            low = min(slots)
            k = slots.index(low)
            key = order(max(low, EPOCH))
            for j in range(k):     # an earlier slot within the key's ulps
                if order(max(slots[j], EPOCH)) == key:
                    k = j
                    break
            t_iss = max(now, arr_next) if (open_loop and eoo) else now
            pstart = max(t_iss, slots[k])
            if cost_bmem is not None:
                pstart = max(pstart, pf_bw)
                pf_bw = pstart + cost_bmem
            u_pf = draws.step(step, j_rho) if j_rho is not None else 0.0
            comp = pstart + lmem(u_pf)
            slots[k] = comp
            pf[tid] = comp
        # 6. the context switch; re-queue or park
        now = now + T_sw
        if open_loop and eoo and arr_next > now:
            heapq.heappush(parked, (arr_next, tid))
        elif park:
            heapq.heappush(parked, (max(park_until, now), tid))
        else:
            heapq.heappush(ready, (order(max(pop_now, thr_ready_key)), tid))
        step += 1

    elapsed = max(float(now) - float(t_start), 1e-12)
    return Cell(throughput=float(n_ops) / elapsed, time=elapsed,
                mem_stall_total=float(stall_total), mem_accesses=mem_acc,
                hist=hist, lat_max=lat_max if collect else math.nan,
                missed=missed)
