"""Open-loop arrival processes and the tail-latency accumulator.

The paper's Eq. 14 story is a *closed-loop* mean: every thread always has
an op in hand, so the model never sees queueing delay.  Production KV
services are judged open loop -- requests arrive on their own clock
(Poisson, bursty, diurnal), and the binding metric is P99 *sojourn* time
(arrival -> completion), not mean service time.  This module provides:

* :class:`ArrivalSpec` -- a frozen, serializable description of an arrival
  process (``poisson`` | ``bursty`` | ``diurnal`` | ``mix``), in SI units
  (``rate`` in ops/sec, ``period``/``deadline`` in seconds).
* :func:`generate_arrivals` -- a deterministic, seedable generator turning
  a spec into a monotone ``float64`` timestamp array.  Determinism is a
  contract, not a convenience: the same spec must regenerate the
  byte-identical array so (a) the sweep cell cache can key on the spec
  instead of the data and (b) all three simulation backends replay the
  *same* arrival stream (the loops and the torch grid consume one shared
  array; see ``engine_loop`` / ``replay_torch``).  The generator uses its
  own ``numpy`` RNG, disjoint from the simulator's Mersenne stream, so
  enabling open loop never perturbs closed-loop RNG draw order.
* :class:`LatencySummary` plus :func:`summarize_exact` /
  :func:`summarize_hist` -- the percentile accumulator.  The Python loops
  record exact sojourns and take nearest-rank quantiles; the torch grid
  scatters into a fixed-bin log histogram (``HIST_BINS`` bins,
  ``HIST_BINS_PER_DECADE`` per decade) whose quantile estimates carry a
  documented relative error bound of ``HIST_REL_ERROR`` (< 1.9%) for
  values inside ``[HIST_LO, HIST_LO * 10**HIST_DECADES)``.

Time-drifting Zipf skew -- the workload-side half of "arrival dynamics" --
lives in :func:`repro_torch.core.workloads.drifting_zipf`, since key skew is a
property of the op stream, not of the arrival clock.
"""
from __future__ import annotations

import json
import math
from dataclasses import dataclass, fields
from typing import Sequence

import numpy as np

__all__ = [
    "ArrivalSpec",
    "generate_arrivals",
    "LatencySummary",
    "summarize_exact",
    "summarize_hist",
    "hist_bin",
    "hist_bin_value",
    "HIST_LO",
    "HIST_BINS",
    "HIST_BINS_PER_DECADE",
    "HIST_DECADES",
    "HIST_RATIO",
    "HIST_INV_LN_RATIO",
    "HIST_REL_ERROR",
]

_KINDS = ("poisson", "bursty", "diurnal", "mix")


@dataclass(frozen=True)
class ArrivalSpec:
    """Declarative arrival process (SI units: ops/sec, seconds).

    ``kind`` selects the process:

    ``poisson``
        Homogeneous Poisson at ``rate``.
    ``bursty``
        MMPP on-off: exponentially distributed ON phases (mean
        ``period * on_fraction``) alternating with OFF phases (mean
        ``period * (1 - on_fraction)``); arrivals only during ON at rate
        ``rate / on_fraction`` so the *long-run mean* rate stays ``rate``
        (duty-cycle conservation -- property-tested).
    ``diurnal``
        Non-homogeneous Poisson with sinusoidal rate
        ``rate * (1 + amplitude * sin(2*pi*t / period))`` via thinning.
    ``mix``
        Multi-tenant superposition: each entry of ``tenants`` is the
        ``to_dict()`` form of a non-mix sub-spec; the merged stream is the
        sorted union, truncated to the requested length.  Offered load is
        the sum of tenant rates.

    ``deadline`` (seconds, 0 = disabled) is the per-op SLA: measured ops
    whose sojourn exceeds it count as *missed* and are excluded from the
    percentile accumulator (they still count toward throughput).
    """

    kind: str = "poisson"
    rate: float = 100_000.0
    seed: int = 0
    on_fraction: float = 0.25     # bursty duty cycle
    period: float = 0.01          # bursty mean cycle / diurnal period (s)
    amplitude: float = 0.8        # diurnal relative swing, in [0, 1)
    deadline: float = 0.0         # SLA deadline (s); 0 disables
    tenants: tuple = ()           # mix: tuple of sub-spec dicts

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(
                f"unknown arrival kind {self.kind!r}; valid: {_KINDS}")
        if self.kind == "mix":
            if not self.tenants:
                raise ValueError("mix arrival spec needs >= 1 tenant")
            # Normalize to a hashable tuple-of-dicts and validate eagerly.
            object.__setattr__(self, "tenants", tuple(
                dict(t) for t in self.tenants))
            for i, t in enumerate(self.tenants):
                sub = ArrivalSpec.from_dict(t)
                if sub.kind == "mix":
                    raise ValueError(f"tenant {i}: nested mix not allowed")
        elif self.rate <= 0.0:
            raise ValueError(f"rate must be > 0, got {self.rate}")
        if not 0.0 < self.on_fraction <= 1.0:
            raise ValueError(
                f"on_fraction must be in (0, 1], got {self.on_fraction}")
        if self.period <= 0.0:
            raise ValueError(f"period must be > 0, got {self.period}")
        if not 0.0 <= self.amplitude < 1.0:
            raise ValueError(
                f"amplitude must be in [0, 1), got {self.amplitude}")
        if self.deadline < 0.0:
            raise ValueError(f"deadline must be >= 0, got {self.deadline}")

    @property
    def offered_rate(self) -> float:
        """Long-run mean arrival rate in ops/sec."""
        if self.kind == "mix":
            return sum(ArrivalSpec.from_dict(t).offered_rate
                       for t in self.tenants)
        return self.rate

    def to_dict(self) -> dict:
        return {"kind": self.kind, "rate": self.rate, "seed": self.seed,
                "on_fraction": self.on_fraction, "period": self.period,
                "amplitude": self.amplitude, "deadline": self.deadline,
                "tenants": [dict(t) for t in self.tenants]}

    @classmethod
    def from_dict(cls, d: dict) -> "ArrivalSpec":
        known = {f.name for f in fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(
                f"unknown arrival spec field(s): {sorted(unknown)}")
        d = dict(d)
        if "tenants" in d:
            d["tenants"] = tuple(dict(t) for t in d["tenants"])
        return cls(**d)

    def key(self) -> str:
        """Canonical string form, stable across processes (cache key)."""
        return json.dumps(self.to_dict(), sort_keys=True)


def _tenant_seed(spec: ArrivalSpec, idx: int, sub: dict) -> int:
    # A tenant with an explicit seed keeps it; otherwise derive one from
    # the mix seed + position, so the whole mix regenerates from one spec.
    if "seed" in sub:
        return int(sub["seed"])
    return spec.seed * 1_000_003 + idx + 1


def generate_arrivals(spec: ArrivalSpec | dict, n: int) -> np.ndarray:
    """``n`` monotone nondecreasing arrival timestamps (float64 seconds).

    Pure function of ``(spec, n)``: the same inputs regenerate the
    byte-identical array (``numpy`` PCG64 stream keyed on ``spec.seed``).
    """
    if isinstance(spec, dict):
        spec = ArrivalSpec.from_dict(spec)
    if n <= 0:
        return np.empty(0, dtype=np.float64)
    rng = np.random.default_rng(spec.seed)
    if spec.kind == "poisson":
        return np.cumsum(rng.exponential(1.0 / spec.rate, n))
    if spec.kind == "bursty":
        return _bursty(spec, n, rng)
    if spec.kind == "diurnal":
        return _diurnal(spec, n, rng)
    # mix: superpose tenant streams, keep the earliest n of the union (a
    # valid prefix: the merged n-th arrival is <= every tenant's n-th).
    streams = []
    for i, sub in enumerate(spec.tenants):
        t = ArrivalSpec.from_dict(
            dict(sub, seed=_tenant_seed(spec, i, sub)))
        streams.append(generate_arrivals(t, n))
    return np.sort(np.concatenate(streams), kind="stable")[:n]


def _bursty(spec: ArrivalSpec, n: int, rng: np.random.Generator):
    out = np.empty(n, dtype=np.float64)
    r_on = spec.rate / spec.on_fraction
    mean_on = spec.period * spec.on_fraction
    mean_off = spec.period * (1.0 - spec.on_fraction)
    t = 0.0
    i = 0
    while i < n:
        on_end = t + rng.exponential(mean_on)
        while i < n:
            g = rng.exponential(1.0 / r_on)
            if t + g >= on_end:
                break
            t += g
            out[i] = t
            i += 1
        t = on_end
        if mean_off > 0.0:
            t += rng.exponential(mean_off)
    return out


def _diurnal(spec: ArrivalSpec, n: int, rng: np.random.Generator):
    # Thinning (Lewis-Shedler): candidate stream at the peak rate, accept
    # with probability r(t)/r_max.  Strictly increasing by construction.
    out = np.empty(n, dtype=np.float64)
    r_max = spec.rate * (1.0 + spec.amplitude)
    two_pi_over_p = 2.0 * math.pi / spec.period
    t = 0.0
    i = 0
    while i < n:
        t += rng.exponential(1.0 / r_max)
        r_t = spec.rate * (1.0 + spec.amplitude
                           * math.sin(two_pi_over_p * t))
        if rng.random() * r_max < r_t:
            out[i] = t
            i += 1
    return out


# ---------------------------------------------------------------------------
# Percentile accumulator
# ---------------------------------------------------------------------------
#
# The loops keep exact per-op sojourns and take nearest-rank quantiles at
# finalize.  The torch grid cannot hold per-op lists, so it scatters counts
# into a fixed-bin log histogram: bins at ratio HIST_RATIO = 10**(1/64)
# spanning [HIST_LO, HIST_LO * 10**HIST_DECADES) = [0.1 us, 10 s).
# Reporting a bin's *geometric midpoint* bounds the relative quantile
# error by sqrt(HIST_RATIO) - 1 = HIST_REL_ERROR < 1.9% for in-range
# values (out-of-range values clamp to the edge bins).

HIST_LO = 1e-7                     # 0.1 us: well under one T_sw
HIST_BINS_PER_DECADE = 64
HIST_DECADES = 8                   # up to 10 s
HIST_BINS = HIST_BINS_PER_DECADE * HIST_DECADES
HIST_RATIO = 10.0 ** (1.0 / HIST_BINS_PER_DECADE)
HIST_INV_LN_RATIO = HIST_BINS_PER_DECADE / math.log(10.0)
HIST_REL_ERROR = math.sqrt(HIST_RATIO) - 1.0   # ~0.0182

_QS = (0.5, 0.9, 0.99)


def hist_bin(v) -> np.ndarray:
    """Log-histogram bin index for value(s) ``v`` (seconds), clamped."""
    v = np.maximum(np.asarray(v, dtype=np.float64), HIST_LO)
    b = np.floor(np.log(v / HIST_LO) * HIST_INV_LN_RATIO)
    return np.clip(b, 0, HIST_BINS - 1).astype(np.int64)


def hist_bin_value(b) -> np.ndarray:
    """Geometric midpoint of bin ``b`` (the reported quantile value)."""
    return HIST_LO * HIST_RATIO ** (np.asarray(b, dtype=np.float64) + 0.5)


@dataclass(frozen=True)
class LatencySummary:
    """Per-cell sojourn-latency tail summary (seconds).

    ``count`` ops contribute to the percentiles; ``missed`` more completed
    but blew the SLA deadline and are excluded.  ``source`` records which
    accumulator produced it: ``"exact"`` (loops, nearest-rank) or
    ``"hist"`` (grid log-histogram, error bound ``HIST_REL_ERROR``).
    An empty cell (every op missed) carries NaN percentiles.
    """

    count: int
    p50: float
    p90: float
    p99: float
    max: float
    missed: int = 0
    source: str = "exact"

    @property
    def miss_rate(self) -> float:
        total = self.count + self.missed
        return self.missed / total if total else 0.0

    def to_dict(self) -> dict:
        return {"count": self.count, "p50": self.p50, "p90": self.p90,
                "p99": self.p99, "max": self.max, "missed": self.missed,
                "source": self.source}

    @classmethod
    def from_dict(cls, d: dict) -> "LatencySummary":
        return cls(**d)


def summarize_exact(values: Sequence[float],
                    missed: int = 0) -> LatencySummary:
    """Nearest-rank quantiles over exact sojourns (the loop backends)."""
    n = len(values)
    if n == 0:
        nan = float("nan")
        return LatencySummary(0, nan, nan, nan, nan, missed, "exact")
    s = sorted(values)
    p50, p90, p99 = (s[max(math.ceil(q * n) - 1, 0)] for q in _QS)
    return LatencySummary(n, p50, p90, p99, s[-1], missed, "exact")


def summarize_hist(counts: np.ndarray, vmax: float,
                   missed: int = 0) -> LatencySummary:
    """Quantiles from a log-histogram (the torch grid backend).

    ``counts`` is the per-bin count vector (any real dtype holding exact
    integers), ``vmax`` the exactly-tracked maximum sojourn.
    """
    counts = np.asarray(counts, dtype=np.float64)
    total = int(round(float(counts.sum())))
    if total == 0:
        nan = float("nan")
        return LatencySummary(0, nan, nan, nan, nan, missed, "hist")
    cum = np.cumsum(counts)
    qs = []
    for q in _QS:
        rank = math.ceil(q * total)
        b = int(np.searchsorted(cum, rank, side="left"))
        qs.append(float(hist_bin_value(b)))
    return LatencySummary(total, qs[0], qs[1], qs[2], float(vmax),
                          missed, "hist")
