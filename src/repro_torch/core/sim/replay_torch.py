"""Vectorized grid replay: the whole latency x threads grid on one device.

The loop backends (:mod:`.engine_loop`) re-run an interpreter per grid cell;
this module instead lowers the columnar :class:`~repro_torch.core.trace_ir.
CompiledTrace` into device tensors **once** (:class:`TraceArrays`), expresses
one cell's scheduler recurrence as a sequence of suboperation *steps*, and
batches that recurrence across every ``(L_mem, n_threads)`` cell of a sweep
(:func:`sweep_grid`).  It is the counterpart of the reference's
``repro/core/sim/replay_jax.py``.

The recurrence
--------------
One step executes exactly one suboperation of one thread in every grid cell.
The step body lives in :mod:`repro_torch.kernels.sched_step` (see that
module for the state layout): on a CUDA device the hand-written kernel
advances every cell of every cohort by a whole block of steps per launch
(:func:`~repro_torch.kernels.sched_step.fused_steps_group`); on the CPU the
plain PyTorch body runs step by step.

Cells that complete their measured ops latch their measurement (the counters
stop; the simulation harmlessly idles on) while the slower cells drain; the
step count is a worst-case bound computed from the trace's op-length prefix
sums, so no cell can run out of steps, and the chunk loop stops early once
every cell of a cohort has latched.  Grids whose thread candidates span a
wide range are split into power-of-two thread *buckets* so small-thread
cells do not pay the widest cell's ``T_max`` padding (per-cell RNG purity
makes the split invisible to results).

Exactness
---------
Scheduling, device arithmetic, and draw *distributions* match the loop
backends; the RNG streams do not (a counter-based splitmix64 generator here,
the stdlib Mersenne twister there), and simultaneous-ready ties can resolve
in a different order.  Per-cell throughput therefore agrees with the loop
backends to sampling noise rather than bit-identically: within
``1% * max(1, sqrt(20000 / n_ops))`` per cell, the ``torch-vs-loop``
contract (:func:`repro_torch.core.conformance.grid_tol`).  Fed the *same* uniforms
(``draws=``), the grid is bit-identical to the reference's ``sweep_grid``.
A cell's numbers are a pure function of ``(cfg.seed, crc32(pack("<dq", L,
n)))`` -- never of grid composition, padding or cohort -- and the generator
is written in integer tensor operations, so the CPU and the card draw the
same bits.

Everything is float64: the state mixes ~second-scale clocks with 50 ns
context switches, which float32 cannot carry.

``host_devices=N`` splits each cohort's cells into N contiguous shards,
one per CUDA device ``cuda:0 .. N-1`` (the reference shard_maps the cell
axis over N XLA host devices); each shard exits early on its own and the
results merge in cell order, bit-identical to one device.  On
``device="cpu"`` the N shards run one after another on the host.  Not
carried over: ``unroll`` (scan unrolling), which has no counterpart here.
"""
from __future__ import annotations

import contextlib
import dataclasses
import numbers
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from ... import obs
from ...kernels import sched_step as sk
from ..trace_ir import CPU, CompiledTrace
from .arrivals import HIST_BINS, LatencySummary, hist_bin_value
from .config import SimConfig, SimResult

__all__ = ["TraceArrays", "GridResult", "sweep_grid", "lower_trace",
           "SplitMixDraws", "init_state", "state_from_numpy",
           "state_to_numpy", "resolve_device", "Cohort", "plan_grid",
           "cohort_uniforms"]

_STEP_BUCKET = 4096     # step bounds round up to this
_PAD_SENTINEL = CPU     # padded suboperations are inert plain-CPU entries
_RNG_CHUNK = 1024       # steps per generated uniform block
# The early exit reads a device flag on the host (a synchronisation), so it
# is tested once per this many chunks; step bounds are whole multiples.
_EXIT_CHECK_CHUNKS = _STEP_BUCKET // _RNG_CHUNK


def resolve_device(device) -> torch.device:
    """``None`` means the card: ``"cuda"``, or ``RuntimeError`` without one.
    The caller asks for the CPU explicitly (``device="cpu"``)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run the plain PyTorch "
                "version on the host")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        if not torch.cuda.is_available():
            raise RuntimeError("device='cuda' requested but CUDA is not "
                               "available")
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _bucket(n: int, bucket: int) -> int:
    return max(bucket, -(-n // bucket) * bucket)


@dataclass(frozen=True)
class TraceArrays:
    """A :class:`CompiledTrace` lowered to device tensors, shape-padded.

    ``kinds``/``durs`` are the flat suboperation columns; ``op_starts`` /
    ``op_ends`` are the per-op slice bounds (``bounds[:-1]``/``bounds[1:]``
    of the source trace).  Arrays are padded up to buckets; ``n_ops`` /
    ``n_subops`` are the true (pre-padding) counts, and the replay indexes
    ops modulo ``n_ops`` so padding is never executed.  ``to_trace``
    reconstructs the source trace losslessly.
    """

    kinds: torch.Tensor      # int32 (n_subops_padded,)
    durs: torch.Tensor       # float64 (n_subops_padded,)
    op_starts: torch.Tensor  # int32 (n_ops_padded,)
    op_ends: torch.Tensor    # int32 (n_ops_padded,)
    n_ops: int
    n_subops: int

    @classmethod
    def from_trace(cls, trace: CompiledTrace, bucket: int = 1024,
                   device="cpu") -> "TraceArrays":
        n_ops, n_subops = trace.n_ops, trace.n_subops
        kinds = np.full(_bucket(n_subops, bucket), _PAD_SENTINEL,
                        dtype=np.int32)
        kinds[:n_subops] = trace.kinds
        durs = np.zeros(len(kinds), dtype=np.float64)
        durs[:n_subops] = trace.durs
        n_ops_pad = _bucket(n_ops, bucket)
        starts = np.empty(n_ops_pad, dtype=np.int32)
        ends = np.empty(n_ops_pad, dtype=np.int32)
        starts[:n_ops] = trace.bounds[:-1]
        ends[:n_ops] = trace.bounds[1:]
        starts[n_ops:] = trace.bounds[-2]    # replicate the last op; the
        ends[n_ops:] = trace.bounds[-1]      # replay never reads past n_ops
        return cls.from_columns(kinds, durs, starts, ends, n_ops, n_subops,
                                device)

    @classmethod
    def from_columns(cls, kinds, durs, op_starts, op_ends, n_ops: int,
                     n_subops: int, device="cpu") -> "TraceArrays":
        """Build from already-lowered (padded) numpy columns -- how a trace
        lowered by the reference package is carried across."""
        dev = torch.device(device)

        def put(a, dt):
            # a copy: trace columns are read-only numpy arrays
            return torch.from_numpy(np.array(a, dtype=dt)).to(dev)

        return cls(put(kinds, np.int32), put(durs, np.float64),
                   put(op_starts, np.int32), put(op_ends, np.int32),
                   int(n_ops), int(n_subops))

    def to(self, device) -> "TraceArrays":
        dev = torch.device(device)
        if self.kinds.device == dev:
            return self
        return TraceArrays(self.kinds.to(dev), self.durs.to(dev),
                           self.op_starts.to(dev), self.op_ends.to(dev),
                           self.n_ops, self.n_subops)

    def to_trace(self) -> CompiledTrace:
        """Decode back to the exact source :class:`CompiledTrace`."""
        starts = self.op_starts.cpu().numpy()[: self.n_ops]
        ends = self.op_ends.cpu().numpy()[: self.n_ops]
        bounds = np.concatenate([starts, ends[-1:]]).astype(np.int64)
        return CompiledTrace.from_columns(
            self.kinds.cpu().numpy()[: self.n_subops].astype(np.int8),
            self.durs.cpu().numpy()[: self.n_subops],
            bounds,
        )


def lower_trace(trace: CompiledTrace, bucket: int = 1024,
                device="cpu") -> TraceArrays:
    """Functional alias for :meth:`TraceArrays.from_trace`."""
    return TraceArrays.from_trace(trace, bucket, device)


@dataclass(frozen=True)
class GridResult:
    """Per-cell sweep results, shaped ``(n_latencies, n_candidates)``.

    ``cell_steps_bound`` / ``cell_steps_run`` sum, over all cells, the steps
    their cohort *scheduled* (the per-cohort worst-case bound) vs. actually
    *executed* before the cohort's early exit fired.
    """

    throughput: np.ndarray
    time: np.ndarray
    mem_stall_total: np.ndarray
    mem_accesses: np.ndarray
    ops: int                      # measured ops per cell (same for all)
    steps: int                    # step bound (max across cohorts)
    cell_steps_bound: int = 0     # sum over cells of their cohort's bound
    cell_steps_run: int = 0       # sum over cells of executed steps
    # Tail-latency planes, present only when ``collect_percentiles`` was
    # on: histogram-derived percentiles (source="hist"; each within
    # arrivals.HIST_REL_ERROR of the exact value), the exact max, the
    # recorded count, and the deadline-missed count per cell.
    p50: np.ndarray | None = None
    p90: np.ndarray | None = None
    p99: np.ndarray | None = None
    lat_max: np.ndarray | None = None
    lat_count: np.ndarray | None = None
    missed: np.ndarray | None = None
    # Raw per-cell histogram counts, (n_latencies, n_candidates, HIST_BINS).
    lat_hist: np.ndarray | None = None

    def result(self, li: int, ci: int) -> SimResult:
        """One cell as a :class:`SimResult` (no per-op latency columns --
        use the loop backends for those)."""
        summary = None
        missed = 0
        if self.p50 is not None:
            missed = int(self.missed[li, ci])
            summary = LatencySummary(
                count=int(self.lat_count[li, ci]),
                p50=float(self.p50[li, ci]),
                p90=float(self.p90[li, ci]),
                p99=float(self.p99[li, ci]),
                max=float(self.lat_max[li, ci]),
                missed=missed,
                source="hist",
            )
        return SimResult(
            ops=self.ops,
            time=float(self.time[li, ci]),
            throughput=float(self.throughput[li, ci]),
            mem_stall_total=float(self.mem_stall_total[li, ci]),
            mem_accesses=int(self.mem_accesses[li, ci]),
            missed_ops=missed,
            latency_summary=summary,
        )


# -- pure-numpy planners -------------------------------------------------------


def _max_window_subops(bounds: np.ndarray, n_window_ops: int) -> int:
    """Worst-case suboperation count of ``n_window_ops`` consecutive ops of
    the cyclic trace, over all start offsets (exact, via prefix sums)."""
    lens = np.diff(bounds)
    n = len(lens)
    total = int(lens.sum())
    cycles, rem = divmod(n_window_ops, n)
    worst_rem = 0
    if rem:
        cs = np.concatenate([[0], np.cumsum(np.concatenate([lens, lens]))])
        worst_rem = int((cs[rem: rem + n] - cs[:n]).max())
    return cycles * total + worst_rem


def _steps_bound(trace: CompiledTrace, n_ops: int, max_warmup: int,
                 max_threads: int) -> int:
    """Step count guaranteeing every cell completes its measured ops.

    A cell terminates once ``warmup + n_ops - 1`` ops have completed; every
    executed suboperation belongs to an op issued from the shared cyclic
    cursor, and at most ``completions + n_threads`` ops are ever issued --
    a consecutive window whose suboperation count bounds the step count.
    """
    window = max_warmup + n_ops + max_threads
    return _bucket(_max_window_subops(trace.bounds, window), _STEP_BUCKET)


def _make_flags(cfg: SimConfig) -> dict:
    """Static specialization flags of one configuration."""
    return dict(
        has_eps=cfg.eps > 0.0,
        has_rho=cfg.rho < 1.0,
        has_jitter=cfg.L_io_jitter > 0.0,
        has_rio=cfg.R_io > 0.0,
        has_bio=cfg.B_io > 0.0,
        has_bmem=cfg.B_mem > 0.0,
        has_lock=cfg.T_lock > 0.0,
        has_degrade=cfg.io_degrade != 1.0,
    )


def _thread_buckets(candidates: Sequence[int]) -> list[list[int]]:
    """Group candidate indices by the power-of-two ceiling of their thread
    count, so narrow cells never pay a wide cell's ``T_max`` padding."""
    groups: dict[int, list[int]] = {}
    for j, c in enumerate(candidates):
        b = 1 if c <= 1 else 1 << (c - 1).bit_length()
        groups.setdefault(b, []).append(j)
    return [ix for _, ix in sorted(groups.items())]


def _cohorts(source: CompiledTrace, candidates: Sequence[int], n_ops: int,
             warmup_ops: int | None, n_cores: int,
             bucket_threads: bool) -> list[tuple[list[int], int, int]]:
    """Partition candidate columns into cohorts: ``(cols, T_max, steps)``
    groups sharing a thread bucket *and* a step bound, so a cohort's early
    exit is never held open by a cell with a structurally larger bound.
    Per-cell RNG purity makes any partition result-invariant;
    ``bucket_threads=False`` collapses everything into the single
    monolithic layout (one ``T_max``, one global bound)."""
    if not bucket_threads:
        T_max = max(candidates)
        warm = (warmup_ops if warmup_ops is not None
                else 2 * T_max * n_cores)
        steps = _steps_bound(source, n_ops, warm, T_max * n_cores)
        return [(list(range(len(candidates))), T_max, steps)]
    groups: dict[tuple[int, int], list[int]] = {}
    for j, c in enumerate(candidates):
        b = 1 if c <= 1 else 1 << (c - 1).bit_length()
        warm = warmup_ops if warmup_ops is not None else 2 * c * n_cores
        steps = _steps_bound(source, n_ops, warm, c * n_cores)
        groups.setdefault((b, steps), []).append(j)
    return [(ix, max(candidates[j] for j in ix), steps)
            for (_, steps), ix in sorted(groups.items())]


# -- per-cell random streams ---------------------------------------------------


def _i64(x: int) -> int:
    """A 64-bit pattern as the signed Python int torch's int64 holds."""
    x &= 0xFFFFFFFFFFFFFFFF
    return x - (1 << 64) if x >= (1 << 63) else x


_GOLDEN = _i64(0x9E3779B97F4A7C15)
_MUL1 = _i64(0xBF58476D1CE4E5B9)
_MUL2 = _i64(0x94D049BB133111EB)


def _lsr(z, s: int):
    """Logical right shift of int64 bit patterns (``>>`` is arithmetic)."""
    return (z >> s) & ((1 << (64 - s)) - 1)


def _mix(z):
    """splitmix64's output function on int64 tensors (multiplies wrap)."""
    z = z + _GOLDEN
    z = (z ^ _lsr(z, 30)) * _MUL1
    z = (z ^ _lsr(z, 27)) * _MUL2
    return z ^ _lsr(z, 31)


def _unit(bits):
    """The top 53 bits as a float64 in ``[0, 1)`` (exact)."""
    return _lsr(bits, 11).to(torch.float64) * (2.0 ** -53)


class SplitMixDraws:
    """Counter-based uniform source: every draw is a hash of ``(seed, cell
    stream id, purpose, counter)``, computed in integer tensor operations so
    the CPU and the card produce the same bits.  ``init`` gives the per-cell
    cursor draw and the per-thread init draws, ``chunk`` one
    ``(_RNG_CHUNK, n_u, G)`` block of step uniforms.  Any object with these
    two methods (returning tensors or numpy arrays) can be passed to
    :func:`sweep_grid` as ``draws`` -- the tests inject the reference's
    streams that way."""

    def __init__(self, seed: int, device="cpu"):
        self.seed = int(seed)
        self.device = torch.device(device)
        self._chunk_keys = (None, None)     # (stream ids, their chunk keys)

    def _cell_keys(self, stream_ids) -> torch.Tensor:
        ids = torch.as_tensor(np.asarray(stream_ids, dtype=np.int64),
                              device=self.device)
        root = _mix(torch.tensor(_i64(self.seed), dtype=torch.int64,
                                 device=self.device))
        return _mix(root ^ ids)

    def init(self, stream_ids, n_slots: int):
        keys = self._cell_keys(stream_ids)                      # (G,)
        u_cursor = _unit(_mix(_mix(keys)))
        tids = torch.arange(n_slots, device=self.device)
        kt = _mix(_mix(keys + 2)[:, None] + tids[None, :])      # (G, CT)
        j = torch.arange(2, device=self.device)
        u_thread = _unit(_mix(kt[:, :, None] + j))              # (G, CT, 2)
        return u_cursor, u_thread

    def chunk(self, stream_ids, ck: int, n_u: int):
        # The chunk keys of the last stream ids stay on the device: the chunk
        # loop asks for the same cells chunk after chunk, and uploading the
        # ids again would wait for the launch in flight.
        ids = np.asarray(stream_ids, dtype=np.int64)
        last, keys = self._chunk_keys
        if last is None or not np.array_equal(last, ids):
            keys = _mix(self._cell_keys(ids) + 1)               # (G,)
            self._chunk_keys = (ids.copy(), keys)
        step = torch.arange(ck * _RNG_CHUNK, (ck + 1) * _RNG_CHUNK,
                            device=self.device)
        ctr = step[:, None] * 4 + torch.arange(n_u, device=self.device)
        return _unit(_mix(keys[None, None, :] ^ _mix(ctr)[:, :, None]))


# -- state ---------------------------------------------------------------------


def state_from_numpy(planes, device="cpu") -> tuple:
    """A scheduler state tuple given as numpy arrays (the reference's
    planes, in its order) as the port's tuple of contiguous tensors."""
    dev = torch.device(device)
    return tuple(
        torch.from_numpy(np.ascontiguousarray(np.asarray(p))).to(dev)
        for p in planes)


def state_to_numpy(state) -> tuple:
    """The inverse of :func:`state_from_numpy`."""
    return tuple(p.detach().cpu().numpy() for p in state)


def init_state(ta: TraceArrays, L_mem_g, nthr_g, warm_g, arr, u_cursor,
               u_thread, *, T_max: int, P: int, n_ssd: int, n_cores: int,
               rho: float, L_dram: float, has_rho: bool, has_io_clock: bool,
               has_arr: bool, has_lat: bool) -> tuple:
    """The initial scheduler state in the :mod:`sched_step` layout.

    Active threads populate the ready ring in tid order (join stamps sit an
    EPOCH apart just above time zero, the tag bits carry the tid);
    parked/inactive slots hold the BIG sentinel / +inf.  Active threads
    consume consecutive trace-cursor slots in core-major tid order, like the
    loops' init.  ``u_cursor`` ``(G,)`` and ``u_thread`` ``(G, CT, 2)`` are
    the init draws.
    """
    f = torch.float64
    i4 = torch.int32
    dev = L_mem_g.device
    G = L_mem_g.shape[0]
    CT = n_cores * T_max
    n_trace = ta.n_ops
    multicore = n_cores > 1
    inf = float("inf")

    tids = torch.arange(CT, device=dev)
    t_local = tids % T_max                 # slot within the owning core
    nthr = nthr_g.long()
    active = t_local[None, :] < nthr[:, None]                   # (G, CT)
    cursor0 = torch.floor(u_cursor * n_trace).long()
    rank = (tids // T_max)[None, :] * nthr[:, None] + t_local[None, :]
    opidx0 = (cursor0[:, None] + rank) % n_trace
    cursor_init = (cursor0 + n_cores * nthr) % n_trace
    L2 = L_mem_g[:, None]
    lm = torch.where(u_thread[:, :, 1] >= rho, L_dram, L2) if has_rho else L2
    pf0 = u_thread[:, :, 0] * lm
    if has_arr:
        # Open loop: thread ``rank`` takes arrival index ``rank``; its first
        # prefetch is anchored at the arrival, and a future arrival parks
        # the thread on the wake plane.
        arr0 = arr[torch.clamp(rank, max=arr.shape[0] - 1)]     # (G, CT)
        pf0 = pf0 + arr0
        parked0 = active & (arr0 > 0.0)
    else:
        arr0 = None
        parked0 = torch.zeros_like(active)

    span0 = sk.pack_span(ta.op_starts[opidx0].to(f), ta.op_ends[opidx0].to(f))
    tids_gt = tids[None, :].expand(G, CT)
    zeros_g = torch.zeros(G, dtype=i4, device=dev)
    ci_cols = [cursor_init.to(i4), zeros_g, zeros_g, zeros_g, zeros_g,
               (warm_g <= 0).to(i4)]
    if has_lat:
        ci_cols.append(zeros_g)                    # missed-op counter
    pft_cols = [pf0, span0]
    if has_lat:
        pft_cols.append(arr0 if has_arr else torch.zeros(G, CT, dtype=f,
                                                         device=dev))
    cf = torch.zeros(G, 6, dtype=f, device=dev)
    cf[:, 3] = -1.0
    slots = torch.arange(P, device=dev).to(f) * sk.EPOCH
    pf_shape = (G, n_cores, P) if multicore else (G, P)
    state = (
        cf,
        torch.stack(ci_cols, dim=1),
        torch.where(active & ~parked0,
                    sk.tag_encode(tids_gt.to(f) * sk.EPOCH, tids_gt),
                    sk.BIG),
        (torch.where(parked0, arr0, inf) if has_arr
         else torch.full((G, CT), inf, dtype=f, device=dev)),
        torch.stack(pft_cols, dim=2),
        slots.expand(pf_shape).contiguous(),
    )
    if multicore:
        state = state + (torch.zeros(G, n_cores, 2, dtype=f, device=dev),)
    if has_io_clock:
        state = state + (torch.zeros(G, n_ssd, dtype=f, device=dev),
                         torch.zeros(G, n_ssd, dtype=f, device=dev))
    if has_lat:
        state = state + (torch.zeros(G, HIST_BINS, dtype=f, device=dev),
                         torch.zeros(G, dtype=f, device=dev))
    return state


# -- the grid ------------------------------------------------------------------

def _as_f64(x, dev) -> torch.Tensor:
    """Draws as a contiguous float64 tensor on ``dev`` (a ``draws`` source
    may return tensors or -- possibly read-only -- numpy arrays)."""
    if not torch.is_tensor(x):
        x = torch.from_numpy(np.array(x, dtype=np.float64))
    return x.to(device=dev, dtype=torch.float64).contiguous()


@dataclass
class Cohort:
    """One cohort of grid cells, ready to step: every tensor
    :func:`~repro_torch.kernels.sched_step.fused_steps_group` takes, the
    initial ``state``, and where the cells' results go (``cols``)."""

    cols: list                 # candidate columns of the grid in this cohort
    T_max: int                 # thread slots per core
    steps: int                 # step bound (a multiple of the chunk)
    G: int                     # cells: n_latencies * len(cols)
    n_u: int                   # uniforms consumed per step
    stream_ids: np.ndarray     # (G,) uint32 per-cell RNG stream ids
    substep: object            # the plain step body (carries the flags)
    state: tuple
    kd: torch.Tensor
    se: torch.Tensor
    arr: torch.Tensor
    n_trace: int
    L_mem_g: torch.Tensor
    nthr_g: torch.Tensor
    warm_g: torch.Tensor
    n_ops: int
    dyn: tuple
    draws: object


def plan_grid(
    cfg: SimConfig,
    trace: CompiledTrace | TraceArrays,
    latencies: Sequence[float],
    thread_candidates: Sequence[int],
    n_ops: int = 5000,
    warmup_ops: int | None = None,
    *,
    device=None,
    bucket_threads: bool = True,
    arrivals: Sequence[float] | None = None,
    collect_percentiles: bool = False,
    deadline: float = 0.0,
    draws=None,
) -> list[Cohort]:
    """Validate a grid and lay it out as :class:`Cohort` s with their
    initial states on ``device`` -- everything :func:`sweep_grid` does
    before the first step (arguments as there)."""
    dev = resolve_device(device)
    if cfg.n_cores < 1:
        raise ValueError(f"n_cores must be >= 1, got {cfg.n_cores}")
    if cfg.collect_load_hist:
        raise ValueError(
            "per-load stall histograms are not available from the torch "
            "backend; use backend='loop'")
    if cfg.n_ssd < 1:
        raise ValueError(f"n_ssd must be >= 1, got {cfg.n_ssd}")
    latencies = list(latencies)
    candidates = [int(n) for n in thread_candidates]
    if not latencies or not candidates:
        raise ValueError("empty sweep grid")
    if not all(isinstance(L, numbers.Real) for L in latencies):
        raise ValueError(
            "the torch backend replays scalar latencies only; "
            "sweep_latency(backend='torch') routes mixture points through "
            "the loop backend")
    if min(candidates) < 1:
        raise ValueError(f"thread candidates must be >= 1: {candidates}")

    with obs.span("grid.lower"):
        source = (trace if isinstance(trace, CompiledTrace)
                  else trace.to_trace())
        ta = (trace.to(dev) if isinstance(trace, TraceArrays)
              else lower_trace(trace, device=dev))
        n_subops = int(ta.op_ends[-1])
    if n_subops >= (1 << sk.SPAN_SHIFT):
        raise ValueError(
            f"trace has {n_subops} suboperations; the fused "
            f"step's span packing supports < 2**{sk.SPAN_SHIFT}")
    if cfg.n_cores * max(candidates) > (1 << sk.TAG_BITS):
        raise ValueError(
            f"n_cores * max threads = {cfg.n_cores * max(candidates)} "
            f"exceeds the {1 << sk.TAG_BITS} thread slots the tag encoding "
            f"supports (TAG_BITS={sk.TAG_BITS}); use backend='loop' for "
            "wider machines")

    has_arr = arrivals is not None
    has_lat = bool(collect_percentiles)
    has_deadline = has_lat and deadline > 0.0
    if deadline < 0.0:
        raise ValueError(f"deadline must be >= 0, got {deadline}")
    arr_np = np.zeros(1, dtype=np.float64)
    if has_arr:
        arr_np = np.asarray(arrivals, dtype=np.float64)
        if arr_np.ndim != 1 or arr_np.size == 0:
            raise ValueError("arrivals must be a non-empty 1-D sequence")
        need = max(
            cfg.n_cores * c
            + (warmup_ops if warmup_ops is not None else 2 * c * cfg.n_cores)
            + n_ops
            for c in candidates)
        if arr_np.size < need:
            raise ValueError(
                f"arrivals has {arr_np.size} timestamps but the widest "
                f"cell consumes up to {need} "
                "(n_cores * n_threads + warmup + n_ops)")
    arr = torch.from_numpy(arr_np).to(dev)

    dyn = tuple(float(d) for d in (
        cfg.T_sw, cfg.eps, cfg.rho, cfg.L_dram, cfg.L_io, cfg.L_io_jitter,
        1.0 / cfg.R_io if cfg.R_io > 0.0 else 0.0,
        cfg.A_io / cfg.B_io if cfg.B_io > 0.0 else 0.0,
        cfg.L_switch,
        cfg.A_mem / cfg.B_mem if cfg.B_mem > 0.0 else 0.0,
        cfg.T_lock,
        deadline,
        cfg.T_degrade,
        cfg.io_degrade,
    ))
    if draws is None:
        draws = SplitMixDraws(cfg.seed, dev)
    flags = _make_flags(cfg)
    has_io_clock = flags["has_rio"] or flags["has_bio"]
    n_u = 2 * flags["has_eps"] + flags["has_jitter"] + flags["has_rho"]
    f = torch.float64

    # Packed trace columns: one gather serves (kind, dur) / (start, end);
    # op bounds are carried as exact f64 integers so a thread's (i, end)
    # pair packs into a single span scalar (see sched_step.pack_span).
    kd = torch.stack([ta.kinds.to(f), ta.durs], dim=1)       # (n_subops, 2)
    se = torch.stack([ta.op_starts.to(f), ta.op_ends.to(f)], dim=1)
    sub = sk.make_substep(
        n_u=n_u, n_ssd=cfg.n_ssd, has_arr=has_arr, has_lat=has_lat,
        has_deadline=has_deadline, n_cores=cfg.n_cores, eager_wmin=True,
        **flags)

    lat_np = np.asarray(latencies, dtype=np.float64)
    n_lat = len(latencies)
    with obs.span("grid.cohorts"):
        layout = _cohorts(source, candidates, n_ops, warmup_ops, cfg.n_cores,
                          bucket_threads)
    out = []
    for cols, T_max, steps in layout:
        with obs.span("grid.init"):
            cand_b = [candidates[j] for j in cols]
            nc = len(cand_b)
            L_mem_g = torch.from_numpy(np.repeat(lat_np, nc)).to(dev)
            nthr_np = np.tile(np.asarray(cand_b, dtype=np.int32), n_lat)
            warm_np = (np.full_like(nthr_np, warmup_ops)
                       if warmup_ops is not None
                       else 2 * nthr_np * cfg.n_cores).astype(np.int32)
            nthr_g = torch.from_numpy(nthr_np).to(dev)
            warm_g = torch.from_numpy(warm_np).to(dev)
            # Each cell's RNG stream is keyed by its (L_mem, n_threads) VALUES,
            # so a cell's result never depends on which other cells -- or
            # cohorts -- share the call (cache purity).
            stream_ids = np.array(
                [zlib.crc32(struct.pack("<dq", L, n))
                 for L in lat_np for n in cand_b],
                dtype=np.uint32,
            )
            u_cursor, u_thread = draws.init(stream_ids, cfg.n_cores * T_max)
            state = init_state(
                ta, L_mem_g, nthr_g, warm_g, arr,
                _as_f64(u_cursor, dev), _as_f64(u_thread, dev),
                T_max=T_max, P=cfg.P, n_ssd=cfg.n_ssd, n_cores=cfg.n_cores,
                rho=dyn[2], L_dram=dyn[3], has_rho=flags["has_rho"],
                has_io_clock=has_io_clock, has_arr=has_arr, has_lat=has_lat)
            out.append(Cohort(
                cols=cols, T_max=T_max, steps=steps, G=n_lat * nc, n_u=n_u,
                stream_ids=stream_ids, substep=sub, state=state, kd=kd, se=se,
                arr=arr, n_trace=ta.n_ops, L_mem_g=L_mem_g, nthr_g=nthr_g,
                warm_g=warm_g, n_ops=int(n_ops), dyn=dyn, draws=draws))
    return out


def cohort_uniforms(cohorts: Sequence[Cohort], ck: int) -> torch.Tensor:
    """The ``(_RNG_CHUNK, n_u, sum G)`` uniform block of chunk ``ck`` for
    ``cohorts`` side by side: one ``draws.chunk`` call over their stream ids
    concatenated.  Every draw is a function of its cell's stream id alone,
    so each cohort's columns are bit for bit the block drawn for that cohort
    alone.
    """
    c0 = cohorts[0]
    dev = c0.L_mem_g.device
    G = sum(c.G for c in cohorts)
    if not c0.n_u:
        return torch.zeros(_RNG_CHUNK, 0, G, dtype=torch.float64, device=dev)
    ids = np.concatenate([c.stream_ids for c in cohorts])
    return _as_f64(c0.draws.chunk(ids, ck, c0.n_u), dev)


def _run_cohorts(cohorts: Sequence[Cohort], *, substeps: int,
                 use_kernel: bool, early_exit: bool) -> list[dict]:
    """Replay every cohort to its step bound (or its early exit) in one
    chunk loop and return each cohort's result planes as numpy arrays.

    Each chunk draws the live cohorts' uniforms in one call and, on the
    card, steps them all in one launch per ``substeps`` steps (in groups of
    ``MAX_COHORTS`` when more are live); the plain step runs cohort by
    cohort.  A cohort leaves the loop after the chunk that reaches its own
    step bound, or -- tested for all live cohorts in one host read every
    ``_EXIT_CHECK_CHUNKS`` chunks -- once all its cells have latched:
    exactly where it would stop if it ran alone."""
    sub = cohorts[0].substep
    states = [c.state for c in cohorts]
    n_chunks = [c.steps // _RNG_CHUNK for c in cohorts]
    chunks_run = [0] * len(cohorts)
    live = [i for i, n in enumerate(n_chunks) if n > 0]
    ck = 0
    while live:
        for g0 in range(0, len(live), sk.MAX_COHORTS):
            ix = live[g0:g0 + sk.MAX_COHORTS]
            cs = [cohorts[i] for i in ix]
            with obs.span("grid.feed"):
                us = cohort_uniforms(cs, ck)
            if use_kernel:
                # In place: the kernel overwrites the state planes, which
                # saves a copy of the whole state per launch.
                parts = [(states[i], c.L_mem_g, c.nthr_g, c.warm_g)
                         for i, c in zip(ix, cs)]
                c0 = cs[0]
                for b in range(0, _RNG_CHUNK, substeps):
                    with obs.span("grid.launch"):
                        sk.fused_steps_group(sub, parts, us[b:b + substeps],
                                             c0.kd, c0.se, c0.arr,
                                             c0.n_trace, c0.n_ops, c0.dyn)
                continue
            off = 0
            for i, c in zip(ix, cs):
                state = states[i]
                with obs.span("grid.launch"):     # on the host: the plain step
                    for k in range(_RNG_CHUNK):
                        state = sub(state, us[k, :, off:off + c.G], c.kd,
                                    c.se, c.arr, c.nthr_g, c.n_trace,
                                    c.L_mem_g, c.warm_g, c.n_ops, c.dyn)
                states[i] = state
                off += c.G
        ck += 1
        for i in live:
            chunks_run[i] = ck
        live = [i for i in live if ck < n_chunks[i]]
        # Finished cells are inert (counters and t_start/t_end are latched),
        # so cutting the tail chunks cannot change any result.
        if early_exit and live and ck % _EXIT_CHECK_CHUNKS == 0:
            with obs.span("grid.exit_read"):
                latched = torch.stack([
                    (states[i][1][:, 3] >= cohorts[i].n_ops).all()
                    for i in live]).tolist()
            live = [i for i, done in zip(live, latched) if not done]

    outs = []
    with obs.span("grid.readback"):
        for c, state, n in zip(cohorts, states, chunks_run):
            cf = state[0].cpu().numpy()
            ci = state[1].cpu().numpy()
            elapsed = np.maximum(cf[:, 4] - cf[:, 3], 1e-12)
            out = dict(
                throughput=np.float64(c.n_ops) / elapsed,
                time=elapsed,
                mem_stall_total=cf[:, 5],
                mem_accesses=ci[:, 4],
                counted=ci[:, 3],
                steps_run=n * _RNG_CHUNK,
            )
            if sub.flags["has_lat"]:
                out["lat_hist"] = state[-2].cpu().numpy()
                out["lat_max"] = state[-1].cpu().numpy()
                out["missed"] = ci[:, 6]
            outs.append(out)
    return outs


def _shard_devices(dev: torch.device, n_dev: int) -> list[torch.device]:
    """The devices of ``n_dev`` cell shards: ``cuda:0 .. n_dev-1``, or the
    host ``n_dev`` times."""
    if n_dev < 1:
        raise ValueError(f"host_devices must be >= 1, got {n_dev}")
    if dev.type != "cuda":
        return [dev] * n_dev
    avail = torch.cuda.device_count()
    if n_dev > avail:
        raise ValueError(
            f"host_devices={n_dev} but torch sees {avail} CUDA device(s); "
            "one shard of the cell axis runs on each device")
    return [torch.device("cuda", k) for k in range(n_dev)]


def _shard_cohort(c: Cohort, lo: int, hi: int, dev: torch.device,
                  draws) -> Cohort:
    """Cells ``[lo, hi)`` of cohort ``c`` on ``dev``: every per-cell tensor
    sliced along its leading cell axis, the shared ones copied."""
    to = lambda t: t.to(dev)
    return dataclasses.replace(
        c, G=hi - lo, stream_ids=c.stream_ids[lo:hi],
        state=tuple(to(t[lo:hi]).contiguous() for t in c.state),
        kd=to(c.kd), se=to(c.se), arr=to(c.arr),
        L_mem_g=to(c.L_mem_g[lo:hi]), nthr_g=to(c.nthr_g[lo:hi]),
        warm_g=to(c.warm_g[lo:hi]), draws=draws)


def _run_sharded(cohorts: Sequence[Cohort], devices: list, draws_for,
                 **run) -> list[dict]:
    """:func:`_run_cohorts` over each cohort's cells split into
    ``len(devices)`` contiguous shards, shard ``k`` on ``devices[k]``, each
    exiting early on its own; the planes merge back in cell order and
    ``steps_run`` becomes per cell.  The shards of distinct CUDA devices run
    side by side (a host thread each), the host's one after another."""
    n = len(devices)
    bounds = [np.linspace(0, c.G, n + 1).round().astype(int) for c in cohorts]
    jobs = []
    for k, dev in enumerate(devices):
        draws = draws_for(dev)
        part = [(i, _shard_cohort(c, int(b[k]), int(b[k + 1]), dev, draws))
                for i, (c, b) in enumerate(zip(cohorts, bounds))
                if b[k + 1] > b[k]]
        jobs.append(part)

    def one(part):
        if not part:
            return []
        dev = part[0][1].L_mem_g.device
        with (torch.cuda.device(dev) if dev.type == "cuda"
              else contextlib.nullcontext()):
            outs = _run_cohorts([c for _, c in part], **run)
        for (_, c), out in zip(part, outs):
            out["steps_run"] = np.full(c.G, out["steps_run"])
        return [(i, out) for (i, _), out in zip(part, outs)]

    if devices[0].type == "cuda" and n > 1:
        with ThreadPoolExecutor(n) as pool:
            done = list(pool.map(one, jobs))
    else:
        done = [one(part) for part in jobs]
    pieces: list[list[dict]] = [[] for _ in cohorts]
    for results in done:                 # device order = cell order
        for i, out in results:
            pieces[i].append(out)
    return [{key: np.concatenate([p[key] for p in ps]) for key in ps[0]}
            for ps in pieces]


def sweep_grid(
    cfg: SimConfig,
    trace: CompiledTrace | TraceArrays,
    latencies: Sequence[float],
    thread_candidates: Sequence[int],
    n_ops: int = 5000,
    warmup_ops: int | None = None,
    *,
    device=None,
    use_kernel: bool | None = None,
    substeps: int | None = None,
    bucket_threads: bool = True,
    early_exit: bool = True,
    host_devices: int | None = None,
    arrivals: Sequence[float] | None = None,
    collect_percentiles: bool = False,
    deadline: float = 0.0,
    draws=None,
) -> GridResult:
    """Run the full ``latencies x thread_candidates`` grid on one device;
    see the module docstring for semantics and exactness.

    ``cfg`` supplies everything except ``L_mem``/``n_threads`` (the grid
    axes); ``n_threads`` is *per core*, and ``cfg.n_cores > 1`` replays the
    multi-core scheduler as long as ``n_cores * T_max`` fits the tag bits.
    Scalar latencies only; ``warmup_ops`` defaults per cell to
    ``2 * n_threads * n_cores``, like the loop backends.

    ``device=None`` means the CUDA device (``RuntimeError`` without one);
    pass ``"cpu"`` to run on the host.  ``use_kernel=None`` steps CUDA
    tensors with the fused CUDA kernel and CPU tensors with the plain
    PyTorch body; ``False`` forces the plain body (on either device);
    ``True`` on a CPU device raises.  ``substeps`` is the number of steps
    per kernel launch; it must divide the uniform chunk (1024) and defaults
    to the whole chunk, because on the card launches, not arithmetic, are
    the cost.  These are execution knobs: cell values do not depend on them.

    ``bucket_threads=False`` forces the single monolithic layout;
    ``early_exit=False`` runs every cohort to its full bound (all four
    combinations are bit-identical).

    ``host_devices=N > 1`` splits each cohort's cells into N contiguous
    shards, one per CUDA device ``cuda:0 .. N-1`` (``ValueError`` when
    fewer are visible); on ``device="cpu"`` the shards run one after
    another on the host.  Each shard exits early on its own; the result
    planes are bit-identical to one device, ``cell_steps_run`` counts each
    shard's own steps.

    ``arrivals`` (a monotone timestamp sequence, seconds) switches every
    cell to the open-loop arrival mode: the SAME array drives all cells, so it
    must cover the worst cell's demand ``n_cores * n_threads + warmup +
    n_ops``.  ``collect_percentiles`` accumulates measured sojourns into a
    per-cell log-histogram and fills the ``GridResult`` tail planes;
    ``deadline`` (seconds, 0 = off) counts sojourns above it as missed.

    ``draws`` replaces the uniform source (default
    :class:`SplitMixDraws` seeded by ``cfg.seed``).
    """
    dev = resolve_device(device)
    if use_kernel is None:
        use_kernel = dev.type == "cuda"
    elif use_kernel and dev.type != "cuda":
        raise ValueError(
            "use_kernel=True needs a CUDA device: the fused step is a CUDA "
            f"kernel and device={dev} cannot launch it")
    if substeps is None:
        substeps = _RNG_CHUNK
    if substeps < 1 or _RNG_CHUNK % substeps:
        raise ValueError(
            f"substeps must divide the RNG chunk ({_RNG_CHUNK}): "
            f"{substeps}")
    devices = _shard_devices(dev, 1 if host_devices is None
                             else int(host_devices))
    latencies = list(latencies)
    thread_candidates = list(thread_candidates)
    with obs.span("grid.plan"):
        cohorts = plan_grid(
            cfg, trace, latencies, thread_candidates, n_ops, warmup_ops,
            device=dev, bucket_threads=bucket_threads, arrivals=arrivals,
            collect_percentiles=collect_percentiles, deadline=deadline,
            draws=draws)
    run = dict(substeps=substeps, use_kernel=use_kernel,
               early_exit=early_exit)
    with obs.span("grid.run"):
        if len(devices) > 1:
            outs = _run_sharded(
                cohorts, devices,
                (lambda d: SplitMixDraws(cfg.seed, d)) if draws is None
                else (lambda d: draws), **run)
        else:
            outs = _run_cohorts(cohorts, **run)
    with obs.span("grid.reduce"):
        grid = _gather(cohorts, outs, len(latencies), len(thread_candidates),
                       n_ops, collect_percentiles)
        del cohorts, outs      # the device state is freed inside the span
    obs.count("grid.steps_bound", grid.cell_steps_bound)
    obs.count("grid.steps_run", grid.cell_steps_run)
    return grid


def _gather(cohorts: Sequence[Cohort], outs: list[dict], n_lat: int,
            n_cand: int, n_ops: int,
            collect_percentiles: bool) -> GridResult:
    """The cohorts' result planes scattered into the ``(n_lat, n_cand)``
    grid, with each cell's percentiles from its histogram."""
    has_lat = bool(collect_percentiles)

    shape = (n_lat, n_cand)
    thr = np.empty(shape)
    tim = np.empty(shape)
    stall = np.empty(shape)
    macc = np.empty(shape, dtype=np.int64)
    if has_lat:
        p50 = np.empty(shape)
        p90 = np.empty(shape)
        p99 = np.empty(shape)
        lmax = np.empty(shape)
        lcount = np.empty(shape, dtype=np.int64)
        lmiss = np.empty(shape, dtype=np.int64)
        lhist = np.empty(shape + (HIST_BINS,), dtype=np.int64)
    max_steps = 0
    steps_bound_cells = 0
    steps_run_cells = 0
    for c, out in zip(cohorts, outs):
        cols, steps, G, nc = c.cols, c.steps, c.G, len(c.cols)
        max_steps = max(max_steps, steps)
        if not np.all(out["counted"] >= n_ops):
            short = int(out["counted"].min())
            raise RuntimeError(
                f"torch replay under-ran its step bound ({steps} steps, "
                f"worst cell counted {short}/{n_ops} ops) -- this is "
                "a bug in _steps_bound")
        steps_bound_cells += steps * G
        steps_run_cells += int(np.sum(
            np.broadcast_to(out["steps_run"], (G,))))
        bshape = (n_lat, nc)
        thr[:, cols] = out["throughput"].reshape(bshape)
        tim[:, cols] = out["time"].reshape(bshape)
        stall[:, cols] = out["mem_stall_total"].reshape(bshape)
        macc[:, cols] = out["mem_accesses"].reshape(bshape)
        if has_lat:
            # Host-side percentile reduction, vectorized over cells:
            # nearest-rank on the cumulative counts, exactly
            # arrivals.summarize_hist per row.
            cum = np.cumsum(out["lat_hist"], axis=1)
            total = np.rint(cum[:, -1]).astype(np.int64)
            empty = total == 0
            for q, dest in ((0.5, p50), (0.9, p90), (0.99, p99)):
                rank = np.ceil(q * np.maximum(total, 1))
                b = np.minimum((cum < rank[:, None]).sum(axis=1),
                               HIST_BINS - 1)
                dest[:, cols] = np.where(
                    empty, np.nan, hist_bin_value(b)).reshape(bshape)
            lmax[:, cols] = np.where(
                empty, np.nan, out["lat_max"]).reshape(bshape)
            lcount[:, cols] = total.reshape(bshape)
            lmiss[:, cols] = out["missed"].astype(
                np.int64).reshape(bshape)
            lhist[:, cols, :] = np.rint(out["lat_hist"]).astype(
                np.int64).reshape(bshape + (HIST_BINS,))
    return GridResult(
        throughput=thr,
        time=tim,
        mem_stall_total=stall,
        mem_accesses=macc,
        ops=n_ops,
        steps=max_steps,
        cell_steps_bound=steps_bound_cells,
        cell_steps_run=steps_run_cells,
        p50=p50 if has_lat else None,
        p90=p90 if has_lat else None,
        p99=p99 if has_lat else None,
        lat_max=lmax if has_lat else None,
        lat_count=lcount if has_lat else None,
        missed=lmiss if has_lat else None,
        lat_hist=lhist if has_lat else None,
    )
