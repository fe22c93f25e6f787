"""The discrete-event loops executing operations on the simulated machine.

Two implementations of the same execution model:

  * :func:`simulate` -- the generic loop.  Takes any ``op_source`` callable,
    supports multi-core, and composes the :mod:`.scheduler` and
    :mod:`.devices` layers.  This is the reference semantics.
  * :func:`simulate_compiled` -- the fast path.  Takes a columnar
    :class:`~repro_torch.core.trace_ir.CompiledTrace`, specializes the single-core
    case into one tight loop over flat Python lists (no per-op tuple churn,
    no core heap, inlined scalar latency sampling), and reproduces the
    generic loop's RNG draw order exactly, so its results are bit-identical
    to ``simulate(cfg, trace_source(trace.to_ops()), ...)`` while running
    several times faster.  Multi-core configs run through a compiled
    multi-core specialization (flat per-core rings/prefetch heaps, same
    core-heap event order and RNG draw order as the generic loop, so still
    bit-identical) instead of falling back to the interpreter.

Everything is virtual-time; wall-clock speed is irrelevant to fidelity.
"""
from __future__ import annotations

import heapq
import random
from collections import deque
from dataclasses import replace
from typing import Callable, Iterable, Sequence

from ..trace_ir import CPU, MEM, POSTIO, PREIO, CompiledTrace, Op
from .arrivals import summarize_exact
from .config import DEFAULT_THREAD_CANDIDATES, SimConfig, SimResult
from .devices import SSDClocks, sample_lmem
from .scheduler import Core, ParkedHeap, Thread

__all__ = [
    "simulate",
    "simulate_compiled",
    "microbenchmark_source",
    "trace_source",
    "best_over_threads",
]


def microbenchmark_source(
    M: int,
    T_mem: float,
    T_io_pre: float,
    T_io_post: float,
    n_io: int = 1,
) -> Callable[[random.Random], Op]:
    """The Sec. 4.1 microbenchmark: M pointer-chase accesses then one IO."""
    per_io = [(MEM, T_mem)] * (M // max(n_io, 1))
    sub: list[tuple[int, float]] = []
    if n_io == 0:
        sub = [(MEM, T_mem)] * M
    else:
        for _ in range(n_io):
            sub += per_io + [(PREIO, T_io_pre), (POSTIO, T_io_post)]
    op = Op(tuple(sub))
    return lambda rng: op


def trace_source(ops: Sequence[Op]) -> Callable[[random.Random], Op]:
    """Replay measured traversal traces (from the KV engines), cyclically
    but starting each thread at a random offset so traces interleave."""
    n = len(ops)

    def src(rng: random.Random, _state={}) -> Op:
        i = _state.setdefault("i", rng.randrange(n))
        _state["i"] = (i + 1) % n
        return ops[i]

    return src


def simulate(
    cfg: SimConfig,
    op_source: Callable[[random.Random], Op],
    n_ops: int,
    warmup_ops: int | None = None,
    collect_latency: bool = False,
    *,
    arrivals: Sequence[float] | None = None,
    collect_percentiles: bool = False,
    deadline: float = 0.0,
) -> SimResult:
    """Run the event simulation until ``n_ops`` operations complete.

    ``warmup_ops`` (default: 2 ops per thread) are excluded from throughput
    so the pipeline fill does not bias short runs.

    ``arrivals`` switches the replay to open loop: a monotone timestamp
    sequence (seconds; see :func:`.arrivals.generate_arrivals`) consumed
    one entry per op issue, in issue order (threads in tid order at init,
    then one per completion).  An op whose arrival is in the future parks
    its thread on the shared wake heap until the arrival clock, so
    queueing delay becomes observable; per-op latency is then the
    *sojourn* (arrival -> completion).  With ``collect_percentiles`` the
    measured sojourns are summarized into ``SimResult.latency_summary``;
    ops whose sojourn exceeds ``deadline`` (seconds, 0 = disabled) count
    as ``missed_ops`` and are excluded from the percentiles.  The arrival
    timestamps come from a separate RNG stream, so closed-loop results
    (``arrivals=None``) are untouched.
    """
    rng = random.Random(cfg.seed)
    total_threads = cfg.n_threads * cfg.n_cores
    if warmup_ops is None:
        warmup_ops = 2 * total_threads

    arr_seq = None if arrivals is None else list(arrivals)
    open_loop = arr_seq is not None
    n_arr = len(arr_seq) if open_loop else 0
    if open_loop and n_arr == 0:
        raise ValueError("arrivals must be non-empty when provided")
    arr_i = 0

    cores = [Core() for _ in range(cfg.n_cores)]
    ssd = SSDClocks(cfg)
    lock_next = 0.0

    parked = ParkedHeap()

    def start_op(th: Thread, now: float) -> None:
        nonlocal arr_i
        op = op_source(rng)
        th.subops = op.subops
        th.idx = 0
        if open_loop:
            # Ops are stamped with their arrival, not the fetch time; a
            # stream shorter than the run clamps to its last timestamp
            # (sweep_latency always generates enough -- see _arrival_count).
            th.op_start = arr_seq[arr_i] if arr_i < n_arr else arr_seq[-1]
            arr_i += 1
        else:
            th.op_start = now

    for cid, core in enumerate(cores):
        for t in range(cfg.n_threads):
            th = Thread(cid * cfg.n_threads + t)
            start_op(th, 0.0)
            # The first MEM access of the very first op: treat its prefetch
            # as issued at a random phase before t=0 (threads never start in
            # lockstep on real hardware), so the warm-up does not seed the
            # pathological aligned schedule of Fig. 7(a).  Open loop: the
            # phase offset is anchored at the op's arrival instead.
            th.pf_ready = th.op_start + rng.random() * sample_lmem(cfg, rng)
            if th.op_start > 0.0:
                parked.park(th.op_start, cid, th)
            else:
                core.ready.append(th)

    done = 0
    counted = 0
    t_start_measure = None
    mem_stall = 0.0
    mem_accesses = 0
    op_lat: list[float] = []
    stalls: list[float] = []
    lat_acc: list[float] | None = [] if collect_percentiles else None
    missed = 0
    hist = cfg.collect_load_hist

    # Event loop over cores ordered by their local clocks.
    core_heap = [(0.0, cid) for cid in range(cfg.n_cores)]
    heapq.heapify(core_heap)

    measuring = lambda: done >= warmup_ops  # noqa: E731

    while counted < n_ops:
        # Wake any parked threads whose IO completed before the earliest
        # core time (they rejoin their core's ready ring).
        parked.wake_until(core_heap[0][0], cores)

        t_core, cid = heapq.heappop(core_heap)
        core = cores[cid]
        core.now = max(core.now, t_core)

        if not core.ready:
            # Idle until this core's earliest parked thread wakes (or any
            # parked thread if the core has none -- then just re-arm later).
            wake = parked.earliest_for(cid)
            if wake is None:
                if parked:
                    heapq.heappush(core_heap, (parked.next_wake(), cid))
                # else: deadlock cannot happen (some thread always runnable)
                continue
            core.now = max(core.now, wake)
            parked.wake_until(core.now, cores)
            if not core.ready:
                heapq.heappush(core_heap, (core.now + 1e-9, cid))
                continue

        th = core.ready.popleft()
        kind, dur = th.subops[th.idx]
        now = core.now

        if kind == MEM:
            if cfg.eps > 0.0 and rng.random() < cfg.eps:
                ready_at = now + sample_lmem(cfg, rng)  # premature eviction
            else:
                ready_at = th.pf_ready
            stall = ready_at - now
            if stall > 0.0:
                if measuring():
                    mem_stall += stall
                now = ready_at
            if hist and measuring():
                stalls.append(max(stall, 0.0))
            if measuring():
                mem_accesses += 1
            now += dur
        else:  # PREIO / POSTIO / CPU all just burn their CPU time here
            now += dur

        th.idx += 1
        end_of_op = th.idx >= len(th.subops)

        if end_of_op:
            done += 1
            if measuring():
                if t_start_measure is None:
                    t_start_measure = now
                counted += 1
                if collect_latency or lat_acc is not None:
                    sojourn = now - th.op_start
                    if collect_latency:
                        op_lat.append(sojourn)
                    if lat_acc is not None:
                        if deadline > 0.0 and sojourn > deadline:
                            missed += 1
                        else:
                            lat_acc.append(sojourn)
            start_op(th, now)
            if cfg.T_lock > 0.0:
                start = max(now, lock_next)
                now = start + cfg.T_lock
                lock_next = now

        nkind = th.subops[th.idx][0]
        park_until = None

        if kind == PREIO and not end_of_op:
            # Submit the IO now; completion is gated by the shared SSD clocks.
            park_until = ssd.submit(now, rng)

        if nkind == MEM:
            # Issue the prefetch for the next access (pointer now known).
            # Open loop: a not-yet-arrived op cannot have issued its
            # prefetch before its arrival.
            t_iss = now
            if end_of_op and th.op_start > t_iss:
                t_iss = th.op_start
            th.pf_ready = core.prefetch.issue(t_iss, cfg, rng)

        now += cfg.T_sw  # one context switch per suboperation (yield)
        core.now = now

        if park_until is not None:
            parked.park(max(park_until, now), cid, th)
        elif end_of_op and th.op_start > now:
            # Open loop: the next op has not arrived yet -- park until the
            # arrival clock (closed loop never takes this branch).
            parked.park(th.op_start, cid, th)
        else:
            core.ready.append(th)
        heapq.heappush(core_heap, (core.now, cid))

    t0 = t_start_measure if t_start_measure is not None else 0.0
    t_end = max(c.now for c in cores)
    elapsed = max(t_end - t0, 1e-12)
    return SimResult(
        ops=counted,
        time=elapsed,
        throughput=counted / elapsed,
        mem_stall_total=mem_stall,
        mem_accesses=mem_accesses,
        op_latencies=op_lat,
        load_stalls=stalls,
        missed_ops=missed,
        latency_summary=(summarize_exact(lat_acc, missed)
                         if lat_acc is not None else None),
    )


def simulate_compiled(
    cfg: SimConfig,
    trace: CompiledTrace,
    n_ops: int,
    warmup_ops: int | None = None,
    collect_latency: bool = False,
    *,
    arrivals: Sequence[float] | None = None,
    collect_percentiles: bool = False,
    deadline: float = 0.0,
) -> SimResult:
    """Fast replay of a :class:`CompiledTrace` (bit-identical to the generic
    loop over ``trace_source(trace.to_ops())``; see module docstring).

    The specialization covers all device features (eps, rho, latency
    mixtures, per-SSD token clocks with ``n_ssd`` round-robin striping, the
    ``L_switch`` fan-out hop, memory throttle, T_lock) and the open-loop
    arrival/percentile extensions (see :func:`simulate`); multi-core
    configs route to :func:`_simulate_compiled_multicore`, which keeps the
    generic loop's core-heap event order and RNG draw order.
    """
    if cfg.n_cores != 1:
        return _simulate_compiled_multicore(
            cfg, trace, n_ops, warmup_ops, collect_latency,
            arrivals=arrivals, collect_percentiles=collect_percentiles,
            deadline=deadline)

    rng = random.Random(cfg.seed)
    rrandom = rng.random
    rrandrange = rng.randrange
    if warmup_ops is None:
        warmup_ops = 2 * cfg.n_threads

    kinds, durs, op_starts, op_ends = trace.as_lists()
    n_trace = trace.n_ops

    # Hoist config into locals (attribute loads dominate the interpreted
    # inner loop otherwise).
    P = cfg.P
    T_sw = cfg.T_sw
    T_lock = cfg.T_lock
    eps = cfg.eps
    L_io = cfg.L_io
    jitter = cfg.L_io_jitter
    io_degrade = cfg.io_degrade
    T_degrade = cfg.T_degrade
    has_degrade = io_degrade != 1.0
    R_io = cfg.R_io
    B_io = cfg.B_io
    A_io = cfg.A_io
    B_mem = cfg.B_mem
    A_mem = cfg.A_mem
    hist = cfg.collect_load_hist

    simple_mem = cfg.rho >= 1.0 and isinstance(cfg.L_mem, (int, float))
    lmem_scalar = float(cfg.L_mem) if simple_mem else 0.0

    def sample() -> float:
        # Same draw order as devices.sample_lmem (used on the slow paths).
        return sample_lmem(cfg, rng)

    # Trace cursor, replicating trace_source exactly: one randrange is drawn
    # per fetch (the legacy closure evaluates it as a setdefault argument),
    # only the first draw picks the starting offset.
    cursor = -1

    arr_seq = None if arrivals is None else list(arrivals)
    open_loop = arr_seq is not None
    n_arr = len(arr_seq) if open_loop else 0
    if open_loop and n_arr == 0:
        raise ValueError("arrivals must be non-empty when provided")

    n_threads = cfg.n_threads
    t_idx = [0] * n_threads        # current flat subop index
    t_end = [0] * n_threads        # flat end index of the current op
    t_pf = [0.0] * n_threads       # prefetch completion for subops[idx]
    t_opstart = [0.0] * n_threads

    parked: list[tuple[float, int, int]] = []   # (wake, seq, tid)
    seq = 0
    heappush = heapq.heappush
    heappop = heapq.heappop

    ready: deque[int] = deque()     # FIFO ring of tids
    for tid in range(n_threads):
        j = rrandrange(n_trace)
        if cursor < 0:
            cursor = j
        t_idx[tid] = op_starts[cursor]
        t_end[tid] = op_ends[cursor]
        cursor = (cursor + 1) % n_trace
        a0 = (arr_seq[tid] if tid < n_arr else arr_seq[-1]) if open_loop \
            else 0.0
        t_opstart[tid] = a0
        t_pf[tid] = a0 + rrandom() * (lmem_scalar if simple_mem else sample())
        if a0 > 0.0:
            seq += 1
            heappush(parked, (a0, seq, tid))
        else:
            ready.append(tid)
    arr_i = n_threads
    ready_pop = ready.popleft
    ready_push = ready.append

    pf_inflight: list[float] = []   # the single core's prefetch heap
    pf_bw_next = 0.0
    # Per-SSD token clocks + the round-robin striping cursor (the inlined
    # mirror of devices.SSDClocks; with n_ssd == 1 the arithmetic is the
    # single-device model unchanged).
    n_ssd = cfg.n_ssd
    if n_ssd < 1:
        raise ValueError(f"n_ssd must be >= 1, got {n_ssd}")
    L_switch = cfg.L_switch
    io_tok_next = [0.0] * n_ssd
    io_bw_next = [0.0] * n_ssd
    io_rr = 0
    lock_next = 0.0

    done = 0
    counted = 0
    t_start_measure = None
    mem_stall = 0.0
    mem_accesses = 0
    op_lat: list[float] = []
    stalls: list[float] = []
    lat_acc: list[float] | None = [] if collect_percentiles else None
    missed = 0
    measuring = warmup_ops <= 0

    now = 0.0
    while counted < n_ops:
        while parked and parked[0][0] <= now:
            ready_push(heappop(parked)[2])
        if not ready:
            # All threads parked on IO: idle-skip to the earliest wake.
            wake = parked[0][0]
            if wake > now:
                now = wake
            while parked and parked[0][0] <= now:
                ready_push(heappop(parked)[2])

        tid = ready_pop()
        i = t_idx[tid]
        kind = kinds[i]
        dur = durs[i]

        if kind == 0:  # MEM
            if eps > 0.0 and rrandom() < eps:
                ready_at = now + (lmem_scalar if simple_mem else sample())
            else:
                ready_at = t_pf[tid]
            stall = ready_at - now
            if stall > 0.0:
                if measuring:
                    mem_stall += stall
                now = ready_at
            if measuring:
                if hist:
                    stalls.append(stall if stall > 0.0 else 0.0)
                mem_accesses += 1
            now += dur
        else:
            now += dur

        i += 1
        end_of_op = i >= t_end[tid]

        if end_of_op:
            done += 1
            if done >= warmup_ops:
                measuring = True
                if t_start_measure is None:
                    t_start_measure = now
                counted += 1
                if collect_latency or lat_acc is not None:
                    sojourn = now - t_opstart[tid]
                    if collect_latency:
                        op_lat.append(sojourn)
                    if lat_acc is not None:
                        if deadline > 0.0 and sojourn > deadline:
                            missed += 1
                        else:
                            lat_acc.append(sojourn)
            # Start the next op from the shared cyclic cursor.  The
            # rrandrange draw is discarded on purpose: the legacy
            # trace_source evaluates one per fetch (setdefault argument),
            # and keeping the RNG stream identical keeps results
            # bit-identical to the generic loop.
            rrandrange(n_trace)
            i = op_starts[cursor]
            t_end[tid] = op_ends[cursor]
            cursor = (cursor + 1) % n_trace
            if open_loop:
                t_opstart[tid] = (arr_seq[arr_i] if arr_i < n_arr
                                  else arr_seq[-1])
                arr_i += 1
            else:
                t_opstart[tid] = now
            if T_lock > 0.0:
                start = now if now > lock_next else lock_next
                now = start + T_lock
                lock_next = now

        park_until = None
        if kind == 1 and not end_of_op:  # PREIO: submit the IO now
            dev = io_rr % n_ssd
            io_rr += 1
            svc = now
            if R_io > 0.0:
                if io_tok_next[dev] > svc:
                    svc = io_tok_next[dev]
                io_tok_next[dev] = svc + 1.0 / R_io
            if B_io > 0.0:
                if io_bw_next[dev] > svc:
                    svc = io_bw_next[dev]
                io_bw_next[dev] = svc + A_io / B_io
            # Mid-run degradation keys off the *submission* time (same
            # rule as SSDClocks.submit, so the loops stay bit-identical).
            lat_io = L_io
            if has_degrade and now >= T_degrade:
                lat_io = L_io * io_degrade
            if jitter > 0.0:
                lat_io *= 1.0 + jitter * (2.0 * rrandom() - 1.0)
            park_until = svc + lat_io + L_switch

        if kinds[i] == 0:  # next subop is MEM: issue its prefetch now
            # Open loop: a not-yet-arrived op issues at its arrival clock.
            t_iss = now
            if end_of_op and t_opstart[tid] > t_iss:
                t_iss = t_opstart[tid]
            pq = pf_inflight
            while pq and pq[0] <= t_iss:
                heappop(pq)
            if len(pq) < P:
                start = t_iss
            else:
                start = t_iss if t_iss > pq[0] else pq[0]
            if B_mem > 0.0:
                if pf_bw_next > start:
                    start = pf_bw_next
                pf_bw_next = start + A_mem / B_mem
            comp = start + (lmem_scalar if simple_mem else sample())
            if len(pq) >= P:
                heappop(pq)
            heappush(pq, comp)
            t_pf[tid] = comp

        now += T_sw
        t_idx[tid] = i

        if park_until is not None:
            seq += 1
            heappush(parked, (park_until if park_until > now else now, seq, tid))
        elif end_of_op and t_opstart[tid] > now:
            # Open loop: park until the next op's arrival (closed loop
            # never takes this branch -- t_opstart <= now there).
            seq += 1
            heappush(parked, (t_opstart[tid], seq, tid))
        else:
            ready_push(tid)

    t0 = t_start_measure if t_start_measure is not None else 0.0
    elapsed = max(now - t0, 1e-12)
    return SimResult(
        ops=counted,
        time=elapsed,
        throughput=counted / elapsed,
        mem_stall_total=mem_stall,
        mem_accesses=mem_accesses,
        op_latencies=op_lat,
        load_stalls=stalls,
        missed_ops=missed,
        latency_summary=(summarize_exact(lat_acc, missed)
                         if lat_acc is not None else None),
    )


def _simulate_compiled_multicore(
    cfg: SimConfig,
    trace: CompiledTrace,
    n_ops: int,
    warmup_ops: int | None = None,
    collect_latency: bool = False,
    *,
    arrivals: Sequence[float] | None = None,
    collect_percentiles: bool = False,
    deadline: float = 0.0,
) -> SimResult:
    """Multi-core compiled fast loop, bit-identical to :func:`simulate`.

    A straight transcription of the generic loop's control flow -- the core
    heap ordered by local clocks, per-core FIFO rings and prefetch units,
    the shared parked heap / SSD clocks / lock clock / trace cursor -- onto
    flat lists with the device arithmetic inlined.  Every RNG draw happens
    at the same point in the same order as the generic loop (per-thread
    init: one discarded ``randrange`` per fetch then ``random() * sample``;
    runtime: eps + eviction sample, IO jitter, prefetch sample), so results
    are byte-for-byte identical, just ~2-3x faster in the interpreter.
    """
    rng = random.Random(cfg.seed)
    rrandom = rng.random
    rrandrange = rng.randrange
    n_threads = cfg.n_threads
    n_cores = cfg.n_cores
    if warmup_ops is None:
        warmup_ops = 2 * n_threads * n_cores

    kinds, durs, op_starts, op_ends = trace.as_lists()
    n_trace = trace.n_ops

    P = cfg.P
    T_sw = cfg.T_sw
    T_lock = cfg.T_lock
    eps = cfg.eps
    L_io = cfg.L_io
    jitter = cfg.L_io_jitter
    io_degrade = cfg.io_degrade
    T_degrade = cfg.T_degrade
    has_degrade = io_degrade != 1.0
    R_io = cfg.R_io
    B_io = cfg.B_io
    A_io = cfg.A_io
    B_mem = cfg.B_mem
    A_mem = cfg.A_mem
    hist = cfg.collect_load_hist

    simple_mem = cfg.rho >= 1.0 and isinstance(cfg.L_mem, (int, float))
    lmem_scalar = float(cfg.L_mem) if simple_mem else 0.0

    def sample() -> float:
        return sample_lmem(cfg, rng)

    cursor = -1
    total_threads = n_threads * n_cores
    t_idx = [0] * total_threads
    t_end = [0] * total_threads
    t_pf = [0.0] * total_threads
    t_opstart = [0.0] * total_threads

    arr_seq = None if arrivals is None else list(arrivals)
    open_loop = arr_seq is not None
    n_arr = len(arr_seq) if open_loop else 0
    if open_loop and n_arr == 0:
        raise ValueError("arrivals must be non-empty when provided")

    ready: list[deque[int]] = [deque() for _ in range(n_cores)]
    core_now = [0.0] * n_cores
    pf_inflight: list[list[float]] = [[] for _ in range(n_cores)]
    pf_bw_next = [0.0] * n_cores

    # Shared parked heap: (wake, seq, cid, tid).  seq breaks wake-time ties
    # FIFO, matching ParkedHeap's deterministic ordering.
    parked: list[tuple[float, int, int, int]] = []
    seq = 0
    heappush = heapq.heappush
    heappop = heapq.heappop

    for cid in range(n_cores):
        rq = ready[cid]
        for t in range(n_threads):
            tid = cid * n_threads + t
            j = rrandrange(n_trace)
            if cursor < 0:
                cursor = j
            t_idx[tid] = op_starts[cursor]
            t_end[tid] = op_ends[cursor]
            cursor = (cursor + 1) % n_trace
            a0 = (arr_seq[tid] if tid < n_arr else arr_seq[-1]) \
                if open_loop else 0.0
            t_opstart[tid] = a0
            t_pf[tid] = a0 + rrandom() * (lmem_scalar if simple_mem
                                          else sample())
            if a0 > 0.0:
                seq += 1
                heappush(parked, (a0, seq, cid, tid))
            else:
                rq.append(tid)
    arr_i = total_threads

    n_ssd = cfg.n_ssd
    if n_ssd < 1:
        raise ValueError(f"n_ssd must be >= 1, got {n_ssd}")
    L_switch = cfg.L_switch
    io_tok_next = [0.0] * n_ssd
    io_bw_next = [0.0] * n_ssd
    io_rr = 0
    lock_next = 0.0

    core_heap = [(0.0, cid) for cid in range(n_cores)]
    heapq.heapify(core_heap)

    done = 0
    counted = 0
    t_start_measure = None
    mem_stall = 0.0
    mem_accesses = 0
    op_lat: list[float] = []
    stalls: list[float] = []
    lat_acc: list[float] | None = [] if collect_percentiles else None
    missed = 0

    while counted < n_ops:
        # Wake threads whose IO completed before the earliest core time.
        horizon = core_heap[0][0]
        while parked and parked[0][0] <= horizon:
            e = heappop(parked)
            ready[e[2]].append(e[3])

        t_core, cid = heappop(core_heap)
        now = core_now[cid]
        if t_core > now:
            now = t_core
        rq = ready[cid]

        if not rq:
            # Idle until this core's earliest parked thread wakes (or re-arm
            # at the global next wake if this core has none parked).
            wake = None
            for e in parked:
                if e[2] == cid and (wake is None or e[0] < wake):
                    wake = e[0]
            if wake is None:
                if parked:
                    heappush(core_heap, (parked[0][0], cid))
                core_now[cid] = now
                continue
            if wake > now:
                now = wake
            while parked and parked[0][0] <= now:
                e = heappop(parked)
                ready[e[2]].append(e[3])
            if not rq:
                heappush(core_heap, (now + 1e-9, cid))
                core_now[cid] = now
                continue

        tid = rq.popleft()
        i = t_idx[tid]
        kind = kinds[i]
        dur = durs[i]

        if kind == 0:  # MEM
            if eps > 0.0 and rrandom() < eps:
                ready_at = now + (lmem_scalar if simple_mem else sample())
            else:
                ready_at = t_pf[tid]
            stall = ready_at - now
            if stall > 0.0:
                if done >= warmup_ops:
                    mem_stall += stall
                now = ready_at
            if done >= warmup_ops:
                if hist:
                    stalls.append(stall if stall > 0.0 else 0.0)
                mem_accesses += 1
            now += dur
        else:
            now += dur

        i += 1
        end_of_op = i >= t_end[tid]

        if end_of_op:
            done += 1
            if done >= warmup_ops:
                if t_start_measure is None:
                    t_start_measure = now
                counted += 1
                if collect_latency or lat_acc is not None:
                    sojourn = now - t_opstart[tid]
                    if collect_latency:
                        op_lat.append(sojourn)
                    if lat_acc is not None:
                        if deadline > 0.0 and sojourn > deadline:
                            missed += 1
                        else:
                            lat_acc.append(sojourn)
            # Shared cyclic cursor; the discarded rrandrange mirrors
            # trace_source's one-draw-per-fetch (see simulate_compiled).
            rrandrange(n_trace)
            i = op_starts[cursor]
            t_end[tid] = op_ends[cursor]
            cursor = (cursor + 1) % n_trace
            if open_loop:
                t_opstart[tid] = (arr_seq[arr_i] if arr_i < n_arr
                                  else arr_seq[-1])
                arr_i += 1
            else:
                t_opstart[tid] = now
            if T_lock > 0.0:
                start = now if now > lock_next else lock_next
                now = start + T_lock
                lock_next = now

        park_until = None
        if kind == 1 and not end_of_op:  # PREIO: shared SSD token clocks
            dev = io_rr % n_ssd
            io_rr += 1
            svc = now
            if R_io > 0.0:
                if io_tok_next[dev] > svc:
                    svc = io_tok_next[dev]
                io_tok_next[dev] = svc + 1.0 / R_io
            if B_io > 0.0:
                if io_bw_next[dev] > svc:
                    svc = io_bw_next[dev]
                io_bw_next[dev] = svc + A_io / B_io
            # Mid-run degradation keys off the *submission* time (same
            # rule as SSDClocks.submit, so the loops stay bit-identical).
            lat_io = L_io
            if has_degrade and now >= T_degrade:
                lat_io = L_io * io_degrade
            if jitter > 0.0:
                lat_io *= 1.0 + jitter * (2.0 * rrandom() - 1.0)
            park_until = svc + lat_io + L_switch

        if kinds[i] == 0:  # next subop is MEM: this core's prefetch unit
            # Open loop: a not-yet-arrived op issues at its arrival clock.
            t_iss = now
            if end_of_op and t_opstart[tid] > t_iss:
                t_iss = t_opstart[tid]
            pq = pf_inflight[cid]
            while pq and pq[0] <= t_iss:
                heappop(pq)
            if len(pq) < P:
                start = t_iss
            else:
                start = t_iss if t_iss > pq[0] else pq[0]
            if B_mem > 0.0:
                if pf_bw_next[cid] > start:
                    start = pf_bw_next[cid]
                pf_bw_next[cid] = start + A_mem / B_mem
            comp = start + (lmem_scalar if simple_mem else sample())
            if len(pq) >= P:
                heappop(pq)
            heappush(pq, comp)
            t_pf[tid] = comp

        now += T_sw
        t_idx[tid] = i
        core_now[cid] = now

        if park_until is not None:
            seq += 1
            heappush(parked,
                     (park_until if park_until > now else now, seq, cid, tid))
        elif end_of_op and t_opstart[tid] > now:
            # Open loop: park until the next op's arrival.
            seq += 1
            heappush(parked, (t_opstart[tid], seq, cid, tid))
        else:
            rq.append(tid)
        heappush(core_heap, (now, cid))

    t0 = t_start_measure if t_start_measure is not None else 0.0
    t_end_time = max(core_now)
    elapsed = max(t_end_time - t0, 1e-12)
    return SimResult(
        ops=counted,
        time=elapsed,
        throughput=counted / elapsed,
        mem_stall_total=mem_stall,
        mem_accesses=mem_accesses,
        op_latencies=op_lat,
        load_stalls=stalls,
        missed_ops=missed,
        latency_summary=(summarize_exact(lat_acc, missed)
                         if lat_acc is not None else None),
    )


def best_over_threads(
    cfg: SimConfig,
    op_source: Callable[[random.Random], Op],
    n_ops: int,
    candidates: Iterable[int] = DEFAULT_THREAD_CANDIDATES,
) -> tuple[SimResult, int]:
    """The paper's protocol: per latency point, optimize the thread count."""
    best: tuple[SimResult, int] | None = None
    for n in candidates:
        r = simulate(replace(cfg, n_threads=n), op_source, n_ops)
        if best is None or r.throughput > best[0].throughput:
            best = (r, n)
    assert best is not None
    return best
