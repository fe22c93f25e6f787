"""Fused whole-step scheduler kernel (batched over grid cells), PyTorch / CUDA.

:mod:`repro_torch.core.sim.replay_torch` replays one scheduler *step* -- wake
the completed parked threads, pop the FIFO ready ring, execute one
suboperation (MEM stall / PREIO submit / op completion), issue the next
prefetch -- for every cell of a latency x threads grid at once.  This module
is that step, two ways:

  * :func:`make_substep` builds the plain PyTorch step body (about 150 tensor
    operations over ``(G, ...)`` planes); the CPU path and the on-card
    comparison use it;
  * :func:`fused_steps` advances the state by K substeps.  On CUDA tensors it
    launches the hand-written kernel ``csrc/sched_step.cu`` (one launch per
    K steps, the state read once and written once); on CPU tensors it loops
    the plain body K times.

Kernel note
-----------
:func:`fused_steps` replaces the TPU kernel ``fused_steps`` of
``src/repro/kernels/sched_step.py`` (body ``make_substep``).  That kernel is
written as dense one-hot selects over whole ``(G, T)`` planes because the
TPU's vector unit has no per-row gather; the CUDA kernel computes the same
values by direct indexing instead.  Cells are independent and each cell is
one serial recurrence, so the kernel is bound neither by bytes nor by
arithmetic throughput but by the *dependent-operation latency of one step
times K*: one warp owns one cell, keeps the thread planes in registers
(lane ``l`` owns slots ``l, l+32, ...``) and the per-row planes in shared
memory, pops the ring with a warp-shuffle ``min`` over int64 bit patterns,
and runs all K steps of a launch without touching device memory for state.
The static flags are run-time arguments (uniform over a launch, so branches
never diverge).  Built with ``-fmad=false``, the kernel is bit-identical to
:func:`make_substep` except for the one transcendental (``log`` in the
histogram bin), which may move a sojourn on a bin edge by one bin.

Tag-encoded minima
------------------
Every plane that is reduced to "earliest entry + which thread" stores its
key with the entry *index* packed into the low :data:`TAG_BITS` bits of the
float64 mantissa (:func:`tag_encode`): a single ``min`` reduction then
returns the winning key and its index together (:func:`tag_tid`).  Keys are
non-negative simulated-time stamps whose meaningful differences dwarf the
``2**TAG_BITS``-ulp tag perturbation, so the encoding never reorders
distinct keys; exact ties break toward the lower index.  PyTorch has no
unsigned 64-bit arithmetic, so the bit patterns are handled as ``int64``:
all keys have a clear sign bit, hence masks and order are unchanged.

State layout
------------
``G`` cells, ``T`` thread slots, ``P`` prefetch slots, ``S`` SSDs -- a plain
tuple of tensors in this order:

  ============  ============  =================================================
  plane         shape/dtype   contents
  ============  ============  =================================================
  ``cf``        (G, 6) f64    0 now, 1 prefetch-bw clock, 2 lock clock,
                              3 t_start, 4 t_end, 5 measured stall seconds
  ``ci``        (G, 6) i32    0 trace cursor, 1 IO round-robin, 2 completed
                              ops, 3 measured ops, 4 measured MEM accesses,
                              5 measuring flag (6 missed ops with ``has_lat``)
  ``stamp``     (G, T) f64    ready threads' ring ticket (tag-encoded pop
                              time); ``BIG`` when parked or inactive
  ``wake``      (G, T) f64    parked threads' IO completion time, stored
                              exact; ``+inf`` when ready or inactive
  ``pft``       (G, T, 2) f64 0 outstanding prefetch completion time,
                              1 trace span ``end * 2**SPAN_SHIFT + i``
                              (2 op start with ``has_lat``)
  ``pf_slots``  (G, P) f64    P-deep in-flight prefetch window completion
                              times, stored exact
  ``io_tok``    (G, S) f64    per-device IOPS token clocks (clock configs)
  ``io_bw``     (G, S) f64    per-device bandwidth token clocks
  ``hist``      (G, 512) f64  sojourn log-histogram counts (``has_lat``)
  ``latmax``    (G,) f64      exact max sojourn (``has_lat``)
  ============  ============  =================================================

With ``n_cores = C > 1`` the thread planes hold ``T = C * T_per_core``
core-major slots tagged by *global* tid, ``pf_slots`` becomes ``(G, C, P)``,
and one extra plane ``cores`` ``(G, C, 2)`` (0 local clock, 1 prefetch-bw
clock) sits between ``pf_slots`` and the IO clocks; ``cf[:, 0]`` then carries
the global drain horizon.

The K-substep batching contract: one :func:`fused_steps` invocation consumes
a ``(K, n_u, G)`` block of pre-drawn uniforms and advances the state by
exactly K substeps -- state crosses the kernel boundary only once per K
steps, and the uniform feed is the only per-step input.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core.sim.arrivals import HIST_BINS, HIST_INV_LN_RATIO, HIST_LO
from ..core.trace_ir import MEM, PREIO
from .token_clock import MAX_DEVICES, token_clock_update

__all__ = [
    "TAG_BITS", "SPAN_SHIFT", "BIG", "EPOCH", "tag_encode", "tag_tid",
    "tag_value", "pack_span", "unpack_span", "make_substep", "fused_steps",
    "DYN_NAMES", "MAX_THREAD_SLOTS", "MAX_SHARED_BYTES",
]

TAG_BITS = 8                       # index bits packed into the mantissa
_TAG_MASK = (1 << TAG_BITS) - 1
_KEY_MASK = ~_TAG_MASK             # as int64: -256

# Sentinel for "no entry" (parked/inactive threads in the stamp plane).
# Finite -- not inf -- so it tag-decodes to thread 0 instead of garbage;
# real stamps stay far below it.
BIG = float(
    (np.float64(1e30).view(np.int64) & np.int64(_KEY_MASK)).view(np.float64))

SPAN_SHIFT = 26                    # pft span packing: end*2**26 + i, exact
_SPAN = float(1 << SPAN_SHIFT)     # in f64 while both stay below 2**26
_INV_SPAN = 1.0 / _SPAN

# Spacing for "time zero, position k" init keys: the smallest *normal* f64,
# so the keys stay ordered and distinct on runtimes that flush denormals.
EPOCH = float(np.finfo(np.float64).tiny)

#: Order of the dynamic scalars in ``dyn`` (the degrade pair last).
DYN_NAMES = ("T_sw", "eps", "rho", "L_dram", "L_io", "jitter", "inv_R",
             "cost_bw_io", "L_switch", "cost_bmem", "T_lock", "deadline",
             "T_degrade", "io_degrade")

MAX_THREAD_SLOTS = 1 << TAG_BITS   # the kernel holds T <= 256 in registers
MAX_SHARED_BYTES = 48 * 1024       # static limit of one block (one cell)


def _bits(x):
    return x.contiguous().view(torch.int64)


def tag_encode(key, idx):
    """Pack ``idx`` into the low :data:`TAG_BITS` mantissa bits of ``key``.

    ``key`` must be non-negative and distinct keys must differ by more than
    ``2**TAG_BITS`` ulps for the order to survive (see module docstring).
    """
    key, idx = torch.broadcast_tensors(key, idx)
    return ((_bits(key) & _KEY_MASK)
            | (idx.to(torch.int64) & _TAG_MASK)).view(torch.float64)


def tag_tid(enc):
    """The index packed by :func:`tag_encode` (int64, ready for indexing)."""
    return _bits(enc) & _TAG_MASK


def tag_value(enc):
    """The key with its tag bits cleared (a 256-ulp floor of the original)."""
    return (_bits(enc) & _KEY_MASK).view(torch.float64)


def pack_span(start, end):
    """``end * 2**SPAN_SHIFT + start`` as exact f64 (both < 2**SPAN_SHIFT)."""
    return end * _SPAN + start


def unpack_span(span):
    """Inverse of :func:`pack_span` -> ``(i, end)`` as f64 integers."""
    end = torch.floor(span * _INV_SPAN)
    return span - end * _SPAN, end


def make_substep(*, n_u, n_ssd, has_eps, has_rho, has_jitter, has_rio,
                 has_bio, has_bmem, has_lock, has_arr=False, has_lat=False,
                 has_deadline=False, has_degrade=False, eager_wmin=True,
                 n_cores=1, token_clock=token_clock_update):
    """Build the plain scheduler substep body, specialized on the static
    config.

    The returned ``substep(state, u, kd, se, arr, nthr_g, n_trace, L_mem_g,
    warm_g, n_ops, dyn) -> state`` advances every cell by one suboperation
    execution and never modifies its inputs.  ``state`` is the tuple
    documented in the module docstring; ``u`` is the ``(n_u, G)`` uniform
    block for this step; ``kd``/``se`` are the packed trace columns
    ``(n_subops, 2)`` / ``(n_ops, 2)``; ``arr`` the shared open-loop arrival
    timestamp vector (read only when ``has_arr``); ``nthr_g`` the per-cell
    thread counts (int32); ``n_trace``/``n_ops`` Python numbers; ``dyn`` the
    tuple of Python floats in :data:`DYN_NAMES` order.

    The flags mean what they mean in the reference: ``has_arr`` replays the
    open-loop arrival mode, ``has_lat`` widens ``pft``/``ci`` and appends the
    ``hist``/``latmax`` planes, ``has_deadline`` classifies late sojourns as
    missed, ``has_degrade`` multiplies ``L_io`` from ``T_degrade`` on,
    ``n_cores > 1`` adds the core axis.

    Per-row reads and writes are gathers and scatters (the reference's
    one-hot select/merge form exists for a vector unit without per-row
    gathers and computes the same values).  ``eager_wmin`` (default here) always runs the starved-cell idle-skip
    re-derivation; ``False`` branches on ``starved.any()``, which costs a
    host synchronisation per step on a CUDA tensor.  The values agree either
    way: a cell that did not starve re-derives identical keys.

    ``token_clock`` is the multi-device grant (``n_ssd > 1``): by default
    :func:`~repro_torch.kernels.token_clock.token_clock_update`, which
    launches its CUDA kernel on CUDA tensors; a comparison that must stay
    independent of both kernels passes ``token_clock_update_ref``.
    """
    has_io_clock = has_rio or has_bio
    multicore = n_cores > 1
    i4 = torch.int32

    def iota(shape, dev):
        return torch.arange(shape[-1], device=dev).expand(shape)

    def sel_thread(plane, tid):
        """``plane[g, tid[g]]`` as a gather along the slot axis."""
        if plane.ndim == 3:
            ix = tid[:, None, None].expand(-1, 1, plane.shape[2])
            return plane.gather(1, ix)[:, 0]
        return plane.gather(1, tid[:, None])[:, 0]

    def upd_thread(plane, tid, val):
        """``plane`` with row ``tid[g]`` of every cell replaced by
        ``val[g]`` (an out-of-place scatter)."""
        if plane.ndim == 3:
            ix = tid[:, None, None].expand(-1, 1, plane.shape[2])
            return plane.scatter(1, ix, val[:, None, :])
        return plane.scatter(1, tid[:, None], val[:, None])

    def substep(s, u, kd, se, arr, nthr_g, n_trace, L_mem_g, warm_g,
                n_ops, dyn):
        (T_sw, eps, rho, L_dram, L_io, jitter, inv_R, cost_bw_io, L_switch,
         cost_bmem, T_lock, deadline, T_degrade, io_degrade) = dyn
        cf, ci, stamp, wake, pft, pf_slots = s[:6]
        si = 6
        if multicore:
            cores = s[si]
            si += 1
        if has_io_clock:
            io_tok, io_bw = s[si], s[si + 1]
            si += 2
        if has_lat:
            lat_hist, latmax = s[si], s[si + 1]
            si += 2
        G, T = stamp.shape
        dev = stamp.device
        un = iter(range(n_u))

        def lmem(uu, L):
            """sample_lmem for scalar latencies: DRAM-tier short-circuit."""
            if has_rho:
                return torch.where(uu >= rho, L_dram, L)
            return L

        counted0 = ci[:, 3]
        reached = counted0 >= n_ops    # cell already took its last op

        if multicore:
            # Core selection: an exact unrolled strict-< scan over the
            # cores' yield clocks (ties to the lower core id), then the
            # single-core ring head / idle-skip over the selected core's
            # thread segment; tags are global tids.
            C, Tpc = n_cores, T // n_cores
            core_now = cores[:, :, 0]                        # (G, C)
            wake3 = wake.reshape(G, C, Tpc)
            stamp3 = stamp.reshape(G, C, Tpc)
            cstar = torch.zeros(G, dtype=torch.int64, device=dev)
            now = core_now[:, 0]
            for c in range(1, C):
                cand = core_now[:, c]
                earlier = cand < now
                cstar = torch.where(earlier, c, cstar)
                now = torch.where(earlier, cand, now)
            wake_c = sel_thread(wake3, cstar)                # (G, Tpc)
            stamp_c = sel_thread(stamp3, cstar)
            gtid_c = cstar[:, None] * Tpc + iota((G, Tpc), dev)
            ring_wake, ring_stamp, ring_tids = wake_c, stamp_c, gtid_c
        else:
            now = cf[:, 0]
            ring_wake, ring_stamp = wake, stamp
            ring_tids = iota((G, T), dev)

        # -- pop the ring head: one tag-encoded min replaces argmin ---------
        # Ring stamps are entry tickets (the pop time at which the thread
        # last started a suboperation); a parked thread whose IO completed
        # joins at its wake time, derived here instead of written back.
        def ring_keys(now_v):
            wkey = tag_encode(
                torch.clamp(torch.clamp(ring_wake, max=BIG), min=T * EPOCH),
                ring_tids)
            return torch.where(ring_wake <= now_v[:, None], wkey, ring_stamp)

        head = ring_keys(now).amin(dim=1)

        # -- idle-skip: nothing ready, nothing eligible -> jump to the ------
        # earliest wake-up and re-derive the keys.
        starved = head >= BIG

        def skip(now_v):
            w_min = ring_wake.amin(dim=1)
            now2 = torch.where(starved, torch.maximum(now_v, w_min), now_v)
            return now2, ring_keys(now2).amin(dim=1)

        if eager_wmin or bool(starved.any()):
            now, head = skip(now)
        pop_now = now
        tid = tag_tid(head)
        # The popped thread's next ring ticket: keyed by its pop time, and
        # clamped to T*EPOCH (above every init stamp, still a normal float).
        ticket = tag_encode(torch.clamp(now, min=T * EPOCH), tid)

        pft_r = sel_thread(pft, tid)                 # (G, 2) or (G, 3)
        pf_tid0 = pft_r[:, 0]
        op_start_r = pft_r[:, 2] if has_lat else None
        i_f, end_f = unpack_span(pft_r[:, 1])
        kd_i = kd[i_f.long()]                        # (G, 2)
        kind = kd_i[:, 0]
        dur = kd_i[:, 1]

        # -- MEM: stall on the outstanding prefetch (or an eps re-fetch) ----
        is_mem = kind == MEM
        ready_at = pf_tid0
        if has_eps:
            u_eps = u[next(un)]
            u_evict = u[next(un)]
            ready_at = torch.where(u_eps < eps,
                                   now + lmem(u_evict, L_mem_g), ready_at)
        stall = ready_at - now
        stalled = is_mem & (stall > 0.0)
        live = (ci[:, 5] > 0) & ~reached
        mem_stall = cf[:, 5] + torch.where(stalled & live, stall, 0.0)
        mem_acc = ci[:, 4] + (is_mem & live)
        now = torch.where(stalled, ready_at, now) + dur

        # -- op completion: counters, measurement window, next op, T_lock ---
        i2 = i_f + 1.0
        eoo = i2 >= end_f
        done = ci[:, 2] + eoo
        meas_evt = eoo & (done >= warm_g) & ~reached
        measuring = torch.maximum(ci[:, 5], meas_evt.to(i4))
        counted = counted0 + meas_evt
        t_start = torch.where(meas_evt & (cf[:, 3] < 0.0), now, cf[:, 3])
        if has_arr:
            # The next op's arrival: completion k (pre-increment ``done``)
            # reads the shared index total_threads + ci[:, 2], clamped to
            # the last entry like the loops' guard.
            arr_next = arr[torch.clamp(
                n_cores * nthr_g + ci[:, 2], max=arr.shape[0] - 1).long()]
        if has_lat:
            # Sojourn at the pre-T_lock completion instant, like the loops.
            sojourn = now - op_start_r
            if has_deadline:
                is_miss = sojourn > deadline
            else:
                is_miss = torch.zeros_like(eoo)
            rec = meas_evt & ~is_miss
            missed = ci[:, 6] + (meas_evt & is_miss)
            b = torch.clamp(
                torch.floor(
                    torch.log(torch.clamp(sojourn, min=HIST_LO) / HIST_LO)
                    * HIST_INV_LN_RATIO),
                0, HIST_BINS - 1).long()
            inc = torch.where(rec, 1.0, 0.0).to(torch.float64)
            lat_hist = lat_hist.scatter_add(1, b[:, None], inc[:, None])
            latmax = torch.where(rec, torch.maximum(latmax, sojourn), latmax)
            op_start_new = torch.where(
                eoo, arr_next if has_arr else now, op_start_r)
        se_c = se[ci[:, 0].long()]                   # (G, 2)
        span_next = torch.where(eoo, pack_span(se_c[:, 0], se_c[:, 1]),
                                pft_r[:, 1] + 1.0)
        ni = torch.where(eoo, se_c[:, 0], i2)
        cursor = torch.where(eoo, (ci[:, 0] + 1) % n_trace, ci[:, 0])
        lock_next = cf[:, 2]
        if has_lock:
            lock_end = torch.maximum(now, lock_next) + T_lock
            now = torch.where(eoo, lock_end, now)
            lock_next = torch.where(eoo, lock_end, lock_next)

        # -- PREIO: submit against the striped per-device token clocks ------
        park = (kind == PREIO) & ~eoo
        io_rr = ci[:, 1]
        if not has_io_clock:
            svc = now
            io_out = ()
        elif n_ssd == 1:
            # Inlined single-device clocks; clocks only advance for cells
            # actually submitting an IO.
            tok1, bw1 = io_tok[:, 0], io_bw[:, 0]
            svc = now
            if has_rio:
                svc = torch.maximum(svc, tok1)
                tok1 = torch.where(park, svc + inv_R, tok1)
            if has_bio:
                svc = torch.maximum(svc, bw1)
                bw1 = torch.where(park, svc + cost_bw_io, bw1)
            io_out = (tok1[:, None], bw1[:, None])
        else:
            devmask = (iota((G, n_ssd), dev)
                       == (io_rr % n_ssd)[:, None]) & park[:, None]
            # The standalone token-clock function: by default its CUDA
            # kernel on CUDA tensors, its plain version on CPU tensors
            # (bit-identical).
            svc, tok2d, bw2d = token_clock(
                now, devmask, io_tok, io_bw, inv_R, cost_bw_io)
            io_out = (tok2d, bw2d)
            io_rr = io_rr + park
        lat_io = L_io
        if has_degrade:
            # The row's current time decides whether this IO pays the
            # degraded latency (submission-time rule, like the loops).
            lat_io = torch.where(now >= T_degrade,
                                 now.new_tensor(L_io * io_degrade),
                                 now.new_tensor(L_io))
        if has_jitter:
            lat_io = lat_io * (1.0 + jitter * (2.0 * u[next(un)] - 1.0))
        park_until = svc + lat_io + L_switch

        # -- issue the next suboperation's prefetch (P-deep window) ---------
        issue = kd[ni.long()][:, 0] == MEM
        if multicore:
            # The selected core's private window + bandwidth clock.
            slots_row = sel_thread(pf_slots, cstar)          # (G, P)
            pf_bw = sel_thread(cores, cstar)[:, 1]
        else:
            slots_row = pf_slots
            pf_bw = cf[:, 1]
        # All P slots in flight <=> the window minimum is still in the
        # future; the minimum slot is also the replacement target.  Slots
        # store exact completion times; the tagged key exists only inside
        # the min reduction.
        slot = tag_tid(tag_encode(torch.clamp(slots_row, min=EPOCH),
                                  iota(slots_row.shape, dev)).amin(dim=1))
        slot_min = sel_thread(slots_row, slot)
        if has_arr:
            # Open loop: a not-yet-arrived op issues at its arrival clock.
            t_iss = torch.where(eoo, torch.maximum(now, arr_next), now)
        else:
            t_iss = now
        pstart = torch.maximum(t_iss, slot_min)
        if has_bmem:
            pstart = torch.maximum(pstart, pf_bw)
            pf_bw = torch.where(issue, pstart + cost_bmem, pf_bw)
        u_pf = u[next(un)] if has_rho else None
        comp = pstart + lmem(u_pf, L_mem_g)
        slots_row = upd_thread(slots_row, slot,
                               torch.where(issue, comp, slot_min))
        pf_slots = (upd_thread(pf_slots, cstar, slots_row) if multicore
                    else slots_row)
        pf_tid = torch.where(issue, comp, pf_tid0)

        # -- yield: context switch, park or re-enter the ready ring ---------
        now = now + T_sw
        inf = float("inf")
        if has_arr:
            # Open loop: the freshly fetched op has not arrived yet -- park
            # until the arrival clock (exclusive with the IO park).
            park_arr = eoo & (arr_next > now)
            parked_any = park | park_arr
            wake_val = torch.where(
                park_arr, arr_next,
                torch.where(park, torch.maximum(park_until, now), inf))
        else:
            parked_any = park
            wake_val = torch.where(park, torch.maximum(park_until, now), inf)
        stamp = upd_thread(stamp, tid, torch.where(parked_any, BIG, ticket))
        wake = upd_thread(wake, tid, wake_val)
        pft_cols = [pf_tid, span_next]
        if has_lat:
            pft_cols.append(op_start_new)
        pft = upd_thread(pft, tid, torch.stack(pft_cols, dim=1))

        crossed = (counted >= n_ops) & ~reached
        if multicore:
            cores = upd_thread(cores, cstar, torch.stack([now, pf_bw], dim=1))
            # -- global drain horizon: the loop's cross-core wake-ups -------
            # ``cf[:, 0]`` carries the horizon H (running max of pop times);
            # threads whose wake fell at or below H while still above their
            # core's clock are materialized into the stamp plane, ticketed
            # one tag-grid step below their core's current clock.
            H = torch.maximum(cf[:, 0], pop_now)
            clock_t = cores[:, :, 0][:, :, None].expand(G, C, Tpc).reshape(
                G, T)
            early = (wake <= H[:, None]) & (wake > clock_t)
            cbits = _bits(torch.clamp(clock_t, min=2.0 * T * EPOCH))
            tail_key = (cbits - (1 << TAG_BITS)).view(torch.float64)
            stamp = torch.where(early,
                                tag_encode(tail_key, iota((G, T), dev)),
                                stamp)
            wake = torch.where(early, inf, wake)
            # Elapsed time is reported against the latest core clock.
            t_end = torch.where(crossed, cores[:, :, 0].amax(dim=1),
                                cf[:, 4])
            pf_bw = cf[:, 1]   # cf slot 1 is unused with a core axis
            now = H            # cf slot 0 carries the drain horizon
        else:
            t_end = torch.where(crossed, now, cf[:, 4])
        cf = torch.stack([now, pf_bw, lock_next, t_start, t_end, mem_stall],
                         dim=1)
        ci_cols = [cursor, io_rr, done, counted, mem_acc, measuring]
        if has_lat:
            ci_cols.append(missed)
        ci = torch.stack([c.to(i4) for c in ci_cols], dim=1)
        out = (cf, ci, stamp, wake, pft, pf_slots)
        if multicore:
            out = out + (cores,)
        out = out + io_out
        if has_lat:
            out = out + (lat_hist, latmax)
        return out

    substep.flags = dict(
        n_u=n_u, n_ssd=n_ssd, has_eps=has_eps, has_rho=has_rho,
        has_jitter=has_jitter, has_rio=has_rio, has_bio=has_bio,
        has_bmem=has_bmem, has_lock=has_lock, has_arr=has_arr,
        has_lat=has_lat, has_deadline=has_deadline, has_degrade=has_degrade,
        n_cores=n_cores)
    return substep


# -- the CUDA launch ----------------------------------------------------------

_FLAG_FIELDS = ("has_eps", "has_rho", "has_jitter", "has_rio", "has_bio",
                "has_bmem", "has_lock", "has_arr", "has_lat", "has_deadline",
                "has_degrade")
_PTR_FIELDS = ("cf", "ci", "stamp", "wake", "pft", "pf_slots", "cores",
               "io_tok", "io_bw", "hist", "latmax", "u", "kd", "se", "arr",
               "L_mem_g", "nthr_g", "warm_g")
_INT_FIELDS = ("G", "T", "P", "S", "C", "W", "NCI", "n_u", "K", "n_trace",
               "n_arr") + _FLAG_FIELDS
_DBL_FIELDS = ("n_ops",) + DYN_NAMES + ("hist_lo", "hist_inv_ln_ratio")


class _SchedArgs(ctypes.Structure):
    """Mirror of ``struct SchedArgs`` in ``csrc/sched_step.cu`` (same field
    order; pointers first, then ints, then doubles)."""
    _fields_ = ([(n, ctypes.c_void_p) for n in _PTR_FIELDS]
                + [(n, ctypes.c_int) for n in _INT_FIELDS]
                + [(n, ctypes.c_double) for n in _DBL_FIELDS])


def _lib():
    from . import _build
    lib = _build.load("sched_step")
    fn = lib.sched_step_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.POINTER(_SchedArgs), ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _shared_bytes(T, W, C, P, S, has_lat):
    n = T * W + C * P + 2 * C + 2 * S + (HIST_BINS if has_lat else 0)
    return 8 * n


def _split_state(state, flags):
    """Name the planes of a state tuple according to the static flags."""
    names = ["cf", "ci", "stamp", "wake", "pft", "pf_slots"]
    if flags["n_cores"] > 1:
        names.append("cores")
    if flags["has_rio"] or flags["has_bio"]:
        names += ["io_tok", "io_bw"]
    if flags["has_lat"]:
        names += ["hist", "latmax"]
    if len(names) != len(state):
        raise ValueError(
            f"state has {len(state)} planes, the flags imply {len(names)} "
            f"({names})")
    return dict(zip(names, state))


def _launch(flags, state, u_block, kd, se, arr, n_trace, L_mem_g, nthr_g,
            warm_g, n_ops, dyn):
    """Validate everything the kernel assumes, then launch it in place on
    ``state``.  Raises on anything it does not take -- never falls back."""
    pl = _split_state(state, flags)
    stamp = pl["stamp"]
    dev = stamp.device
    G, T = stamp.shape
    C = flags["n_cores"]
    has_lat = flags["has_lat"]
    has_clk = flags["has_rio"] or flags["has_bio"]
    W = 3 if has_lat else 2
    NCI = 7 if has_lat else 6
    S = flags["n_ssd"]
    n_u = flags["n_u"]
    P = pl["pf_slots"].shape[-1]
    K = u_block.shape[0]
    f8, i4 = torch.float64, torch.int32
    if T > MAX_THREAD_SLOTS or T % C:
        raise ValueError(
            f"fused_steps kernel takes n_cores * T <= {MAX_THREAD_SLOTS} "
            f"thread slots in whole cores, got T={T}, n_cores={C}")
    if P < 1 or P > (1 << TAG_BITS):
        raise ValueError(f"fused_steps kernel takes 1 <= P <= 256, got {P}")
    if S < 1 or S > MAX_DEVICES:
        raise ValueError(
            f"fused_steps kernel takes 1 <= n_ssd <= {MAX_DEVICES}, got {S}")
    need = _shared_bytes(T, W, C, P, S if has_clk else 0, has_lat)
    if need > MAX_SHARED_BYTES:
        raise ValueError(
            f"fused_steps kernel needs {need} bytes of shared memory per "
            f"cell (T={T}, P={P}, n_cores={C}, n_ssd={S}); the limit is "
            f"{MAX_SHARED_BYTES}")
    if n_u != 2 * flags["has_eps"] + flags["has_jitter"] + flags["has_rho"]:
        raise ValueError("n_u does not match the draw-consuming flags")
    expect = {
        "cf": ((G, 6), f8), "ci": ((G, NCI), i4), "stamp": ((G, T), f8),
        "wake": ((G, T), f8), "pft": ((G, T, W), f8),
        "pf_slots": ((G, C, P) if C > 1 else (G, P), f8),
        "cores": ((G, C, 2), f8), "io_tok": ((G, S), f8),
        "io_bw": ((G, S), f8), "hist": ((G, HIST_BINS), f8),
        "latmax": ((G,), f8),
    }
    tensors = dict(pl)
    tensors.update(kd=kd, se=se, L_mem_g=L_mem_g, nthr_g=nthr_g,
                   warm_g=warm_g)
    expect.update({
        "kd": ((kd.shape[0], 2), f8), "se": ((se.shape[0], 2), f8),
        "L_mem_g": ((G,), f8), "nthr_g": ((G,), i4), "warm_g": ((G,), i4),
    })
    if n_u:
        tensors["u"] = u_block
        expect["u"] = ((K, n_u, G), f8)
    elif tuple(u_block.shape[1:]) != (0, G):
        raise ValueError(
            f"u_block: expected (K, 0, {G}), got {tuple(u_block.shape)}")
    if flags["has_arr"]:
        tensors["arr"] = arr
        expect["arr"] = ((arr.shape[0],), f8)
    for name, t in tensors.items():
        shape, dt = expect[name]
        if (t.device != dev or t.dtype != dt or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(
                f"fused_steps kernel: {name} must be a contiguous {shape} "
                f"{dt} tensor on {dev}; got {tuple(t.shape)} {t.dtype} on "
                f"{t.device}, contiguous={t.is_contiguous()}")
    if n_trace < 1 or n_trace > se.shape[0]:
        raise ValueError(f"n_trace={n_trace} outside the se table")
    a = _SchedArgs()
    for name in _PTR_FIELDS:
        t = tensors.get(name)
        setattr(a, name, t.data_ptr() if t is not None and t.numel() else None)
    for name, v in (("G", G), ("T", T), ("P", P), ("S", S), ("C", C),
                    ("W", W), ("NCI", NCI), ("n_u", n_u), ("K", K),
                    ("n_trace", int(n_trace)),
                    ("n_arr", arr.shape[0] if flags["has_arr"] else 0)):
        setattr(a, name, v)
    for name in _FLAG_FIELDS:
        setattr(a, name, int(bool(flags[name])))
    a.n_ops = float(n_ops)
    for name, v in zip(DYN_NAMES, dyn):
        setattr(a, name, float(v))
    a.hist_lo, a.hist_inv_ln_ratio = HIST_LO, HIST_INV_LN_RATIO
    if G == 0 or K == 0:
        return
    fn = _lib()
    from ._build import check_launch
    with torch.cuda.device(dev):
        code = fn(ctypes.byref(a), torch.cuda.current_stream(dev).cuda_stream)
    check_launch(code, "fused_steps")
    fused_steps.launches += 1


def fused_steps(substep, state, u_block, kd, se, arr, n_trace, L_mem_g,
                nthr_g, warm_g, n_ops, dyn, *, inplace: bool = False):
    """Advance ``state`` by K substeps; returns the new state tuple.

    ``substep`` must come from :func:`make_substep` (it carries the static
    flags); ``u_block`` is the ``(K, n_u, G)`` uniform feed (``n_u`` may be
    0); ``arr`` the shared arrival vector (any tensor when closed loop) and
    ``nthr_g`` the per-cell thread counts.

    State on a CUDA device launches the CUDA kernel once (or raises on what
    the kernel does not take -- it never runs the plain version instead);
    ``fused_steps.launches`` counts those launches.  State on the CPU loops
    the plain ``substep`` K times.  ``inplace=True`` lets the kernel
    overwrite the given planes (the chunk loop does, saving a copy of the
    whole state per launch); the default copies first, like the functional
    reference.
    """
    flags = substep.flags
    if not state[2].is_cuda:
        for k in range(u_block.shape[0]):
            state = substep(state, u_block[k], kd, se, arr, nthr_g, n_trace,
                            L_mem_g, warm_g, n_ops, dyn)
        return state
    if not inplace:
        state = tuple(p.clone(memory_format=torch.contiguous_format)
                      for p in state)
    _launch(flags, state, u_block, kd, se, arr, n_trace, L_mem_g, nthr_g,
            warm_g, n_ops, dyn)
    return state


fused_steps.launches = 0
