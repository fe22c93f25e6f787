"""Device models: memory-latency sampling, SSD token clocks, prefetch queue.

These encapsulate all *device* state of the simulation -- everything that is
not thread scheduling.  The generic event loop and the compiled fast loop in
:mod:`.engine_loop` both build on them; arithmetic and RNG draw order are
kept byte-identical between the two paths so results are reproducible across
refactors.

The token-clock model
---------------------
Every rate-limited resource is modelled as a *token clock*: a single float
holding the earliest time the next grant may start.  Admitting a request at
time ``now`` costs ``max(now, clock)`` as its start time and advances the
clock by the per-request spacing (``1/R_io`` for an IOPS limit, ``bytes/B``
for a bandwidth limit).  That is an exact fluid model of a token bucket with
burst size one; it needs no queues, is O(1) per request, and composes --
an IO is gated first by its device's IOPS clock, then its bandwidth clock,
then pays the device latency (plus jitter and the optional switch hop).
A clock of ``0.0`` with a rate of ``0.0`` disables that limit.

Multi-SSD fan-out
-----------------
With ``cfg.n_ssd > 1`` each device gets its *own* pair of token clocks
(``R_io``/``B_io`` are per-device rates, so aggregate capacity scales with
the device count), and IOs are striped over devices round-robin in global
submission order.  Real stores stripe by data placement (key -> device);
round-robin is the deterministic stand-in that keeps the generic and
compiled loops bit-identical and is exact whenever IOs are
placement-uniform, which the paper's uniform/Zipf-hashed workloads are.
``cfg.L_switch`` adds a fixed CXL/PCIe-switch fan-out hop to every IO's
completion, modelling a device pool hanging off a shared switch.
"""
from __future__ import annotations

import heapq
import random

from .config import SimConfig

__all__ = ["sample_lmem", "SSDClocks", "PrefetchUnit"]


def sample_lmem(cfg: SimConfig, rng: random.Random) -> float:
    """One memory-load latency: DRAM-tier short-circuit, scalar, or mixture."""
    if cfg.rho < 1.0 and rng.random() >= cfg.rho:
        return cfg.L_dram
    lm = cfg.L_mem
    if isinstance(lm, (int, float)):
        return float(lm)
    u = rng.random()
    acc = 0.0
    for lat, prob in lm:
        acc += prob
        if u < acc:
            return lat
    return lm[-1][0]


class SSDClocks:
    """Shared (cross-core) SSD gating: per-device IOPS and bandwidth token
    clocks plus per-IO latency jitter and the switch fan-out hop.

    ``submit`` returns the completion time of an IO submitted at ``now``;
    the IO is placed on the next device in round-robin order and gated by
    that device's clocks only (see the module docstring for the model).
    """

    __slots__ = ("R_io", "B_io", "A_io", "L_io", "jitter", "L_switch",
                 "n_ssd", "degrade", "T_degrade", "tok_next", "bw_next",
                 "_rr")

    def __init__(self, cfg: SimConfig):
        if cfg.n_ssd < 1:
            raise ValueError(f"n_ssd must be >= 1, got {cfg.n_ssd}")
        self.R_io = cfg.R_io
        self.B_io = cfg.B_io
        self.A_io = cfg.A_io
        self.L_io = cfg.L_io
        self.jitter = cfg.L_io_jitter
        self.L_switch = cfg.L_switch
        self.n_ssd = cfg.n_ssd
        self.degrade = cfg.io_degrade
        self.T_degrade = cfg.T_degrade
        self.tok_next = [0.0] * cfg.n_ssd
        self.bw_next = [0.0] * cfg.n_ssd
        self._rr = 0

    def submit(self, now: float, rng: random.Random) -> float:
        dev = self._rr % self.n_ssd
        self._rr += 1
        svc = now
        if self.R_io > 0.0:
            svc = max(svc, self.tok_next[dev])
            self.tok_next[dev] = svc + 1.0 / self.R_io
        if self.B_io > 0.0:
            svc = max(svc, self.bw_next[dev])
            self.bw_next[dev] = svc + self.A_io / self.B_io
        # Mid-run degradation slows the device latency of every IO
        # *submitted* at now >= T_degrade (submission time, not the gated
        # start: a queued IO issued before the fault is still fast).
        lat_io = self.L_io
        if self.degrade != 1.0 and now >= self.T_degrade:
            lat_io = self.L_io * self.degrade
        if self.jitter > 0.0:
            lat_io *= 1.0 + self.jitter * (2.0 * rng.random() - 1.0)
        return svc + lat_io + self.L_switch


class PrefetchUnit:
    """Per-core software-prefetch state: an in-flight completion heap bounded
    by queue depth P, plus the memory-bandwidth throttle spacing prefetch
    starts (A_mem/B_mem)."""

    __slots__ = ("inflight", "bw_next")

    def __init__(self):
        self.inflight: list[float] = []   # heap of completion times
        self.bw_next = 0.0

    def issue(self, now: float, cfg: SimConfig, rng: random.Random) -> float:
        """Issue a prefetch at ``now``; returns its completion time.

        If P slots are all in flight the start is delayed until the earliest
        one completes (Fig. 5); the bandwidth throttle can delay it further.
        """
        pq = self.inflight
        while pq and pq[0] <= now:
            heapq.heappop(pq)
        start = now if len(pq) < cfg.P else max(now, pq[0])
        if cfg.B_mem > 0.0:
            start = max(start, self.bw_next)
            self.bw_next = start + cfg.A_mem / cfg.B_mem
        comp = start + sample_lmem(cfg, rng)
        if len(pq) >= cfg.P:
            heapq.heappop(pq)
        heapq.heappush(pq, comp)
        return comp
