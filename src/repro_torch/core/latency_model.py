"""Analytical throughput models from the paper (Eqs. 1-16).

Implements, in closed form and vectorized over memory latency:

  * Eq. 1   ``theta_single_inv``    -- single-threaded memory-only
  * Eq. 2   ``theta_multi_inv``     -- multi-threaded memory-only, no prefetch cap
  * Eq. 3   ``theta_mem_inv``       -- multi-threaded memory-only with prefetch
                                       queue depth P (Cho et al. regime)
  * Eq. 4   ``lstar_mem``           -- knee latency P*(T_mem+T_sw)
  * Eq. 5/6 ``theta_mask_inv``      -- masking-only memory-and-IO model
  * Eq. 7   ``theta_best_inv``      -- best-case misaligned memory-and-IO model
  * Eq. 8   ``lstar_best``          -- knee latency with IO: + P*E/M
  * Eq. 9-13 ``theta_prob_inv``     -- THE paper's probabilistic model
  * Eq. 14-15 ``theta_extended_inv``-- bandwidth/IOPS caps, tiering rho,
                                       premature-eviction epsilon
  * Eq. 16  ``cost_performance_ratio``

All times are in SECONDS (the paper quotes microseconds; helpers below accept
seconds so they compose with the simulator and the serving planner). All
``*_inv`` functions return the *reciprocal throughput*: expected CPU-core
seconds per KV operation. ``normalized_throughput`` reproduces the paper's
figures, which normalize by the DRAM-latency (0.1 us) operating point.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Callable

import numpy as np

US = 1e-6  # microsecond, for readable call sites

__all__ = [
    "OpParams",
    "SystemParams",
    "theta_single_inv",
    "theta_multi_inv",
    "theta_mem_inv",
    "theta_mask_inv",
    "theta_best_inv",
    "theta_prob_inv",
    "theta_extended_inv",
    "lstar_mem",
    "lstar_best",
    "normalized_throughput",
    "cost_performance_ratio",
    "fit_p_tsw_from_memory_only",
    "PAPER_EXAMPLE",
    "PAPER_SYSTEM",
]


@dataclass(frozen=True)
class OpParams:
    """Operation-model parameters (Table 1 of the paper).

    ``M`` is the average number of (long-latency) memory accesses per
    *operation* and ``S`` the average number of IOs per operation. The
    Sec. 3.2.3 extension splits one op into S sub-operations with M/S
    memory accesses each; the theta functions below do that internally,
    so Table 1's per-IO M equals ``M/S``.  ``N=None`` means "optimally
    many user-level threads" (the paper reports the best N per point).
    """

    M: float = 10.0
    T_mem: float = 0.10 * US
    T_io_pre: float = 4.0 * US
    T_io_post: float = 3.0 * US
    T_sw: float = 0.05 * US
    P: int = 10
    N: int | None = None
    S: float = 1.0

    @property
    def E(self) -> float:
        """Eq. 6: CPU time one IO costs: pre + post + two context switches."""
        return self.T_io_pre + self.T_io_post + 2.0 * self.T_sw


@dataclass(frozen=True)
class SystemParams:
    """System parameters for the extended model (Table 2 of the paper)."""

    A_mem: float = 64.0            # memory access (cacheline) size, bytes
    B_mem: float = 10e9            # max memory bandwidth, bytes/sec
    A_io: float = 1024.0           # SSD access size, bytes
    B_io: float = 10e9             # max SSD bandwidth, bytes/sec
    R_io: float = 2.2e6            # max SSD random IOPS
    rho: float = 1.0               # offload ratio of indices/caches
    eps: float = 0.0               # premature CPU-cache eviction ratio
    L_dram: float = 0.1 * US       # host DRAM latency


PAPER_EXAMPLE = OpParams()          # Table 1 example column
PAPER_SYSTEM = SystemParams()       # Table 2 example column


def _as_array(L_mem) -> np.ndarray:
    return np.atleast_1d(np.asarray(L_mem, dtype=np.float64))


# ---------------------------------------------------------------------------
# Memory-only models (Sec. 3.1)
# ---------------------------------------------------------------------------

def theta_single_inv(L_mem, p: OpParams = PAPER_EXAMPLE) -> np.ndarray:
    """Eq. 1: reciprocal throughput of naive single-threaded execution."""
    L = _as_array(L_mem)
    return p.T_mem + L


def theta_multi_inv(L_mem, p: OpParams = PAPER_EXAMPLE) -> np.ndarray:
    """Eq. 2: multi-threaded, unlimited prefetch queue."""
    L = _as_array(L_mem)
    first = p.T_mem + p.T_sw
    if p.N is None:  # optimal N: second term vanishes
        return np.full_like(L, first)
    return np.maximum(first, (p.T_mem + L) / p.N)


def theta_mem_inv(L_mem, p: OpParams = PAPER_EXAMPLE) -> np.ndarray:
    """Eq. 3: multi-threaded with prefetch-queue depth P."""
    L = _as_array(L_mem)
    out = np.maximum(theta_multi_inv(L, p), L / p.P)
    return out


def lstar_mem(p: OpParams = PAPER_EXAMPLE) -> float:
    """Eq. 4: latency knee of the memory-only model."""
    return p.P * (p.T_mem + p.T_sw)


# ---------------------------------------------------------------------------
# Memory-and-IO models (Sec. 3.2)
# ---------------------------------------------------------------------------

def theta_mask_inv(L_mem, p: OpParams = PAPER_EXAMPLE) -> np.ndarray:
    """Eq. 5: masking-only model -- IO only adds a constant CPU-time offset.

    Represents the *aligned* thread schedule of Fig. 7(a); the paper shows it
    underestimates throughput by up to 32.7%.
    """
    m_per_io = p.M / p.S
    return p.S * (m_per_io * theta_mem_inv(L_mem, p) + p.E)


def theta_best_inv(L_mem, p: OpParams = PAPER_EXAMPLE) -> np.ndarray:
    """Eq. 7: best-case fully misaligned schedule (upper bound on throughput)."""
    L = _as_array(L_mem)
    m_per_io = p.M / p.S
    core = np.maximum(m_per_io * (p.T_mem + p.T_sw) + p.E, m_per_io * L / p.P)
    return p.S * core


def lstar_best(p: OpParams = PAPER_EXAMPLE) -> float:
    """Eq. 8: latency knee with IO -- extended by P*E/M."""
    m_per_io = p.M / p.S
    return p.P * (p.T_mem + p.T_sw) + p.P * p.E / m_per_io


def _logfact(n: np.ndarray) -> np.ndarray:
    return np.vectorize(math.lgamma)(np.asarray(n, dtype=np.float64) + 1.0)


def theta_prob_inv(
    L_mem,
    p: OpParams = PAPER_EXAMPLE,
    sysp: SystemParams | None = None,
    k_max: int = 120,
) -> np.ndarray:
    """Eqs. 9-13: the paper's probabilistic memory-and-IO model.

    With ``sysp`` given, applies the Eq. 15 latency replacement (tiering rho
    and memory-bandwidth floor) and the epsilon premature-eviction extension;
    the Eq. 14 outer IO caps are applied by :func:`theta_extended_inv`.
    """
    L = _as_array(L_mem)
    m_per_io = p.M / p.S
    Mp2 = m_per_io + 2.0

    eps = 0.0 if sysp is None else sysp.eps
    q_mem = (1.0 - eps) * m_per_io / Mp2     # pre-eviction memory subop
    q_pre = 1.0 / Mp2                        # pre-IO subop
    q_post = 1.0 / Mp2                       # post-IO subop
    q_ev = eps * m_per_io / Mp2              # post-eviction memory subop

    P = int(p.P)
    js = np.arange(P + 1)

    if sysp is None:
        L_eff = np.broadcast_to(L, (P + 1, L.size))  # (j, L)
    else:
        tier = sysp.rho * L + (1.0 - sysp.rho) * sysp.L_dram
        bw_floor = ((P - js)[:, None]) * sysp.A_mem / sysp.B_mem
        L_eff = np.maximum(tier[None, :], bw_floor)   # Eq. 15, (j, L)

    base = P * (p.T_mem + p.T_sw)
    red_pre = p.T_io_pre - p.T_mem           # Fig. 8(b)
    red_post = p.T_io_post + p.T_sw          # Fig. 8(c)
    red_ev = L_eff + p.T_sw                  # eviction stall drains like post-IO

    lf = math.lgamma
    log_qmem = math.log(q_mem) if q_mem > 0 else -math.inf
    log_qpre = math.log(q_pre)
    log_qpost = math.log(q_post)
    log_qev = math.log(q_ev) if q_ev > 0 else -math.inf

    num = np.zeros(L.size)
    den = 0.0
    extra_stall = np.zeros(L.size)  # expected direct eviction stall per subop

    m_max = 0 if eps == 0.0 else k_max
    for j in range(P + 1):
        for k in range(k_max + 1):
            for m in range(m_max + 1):
                n_len = P + k + m
                logp = (
                    lf(n_len + 1) - lf(P - j + 1) - lf(j + 1) - lf(k + 1) - lf(m + 1)
                    + (P - j) * log_qmem + j * log_qpre + k * log_qpost
                    + (m * log_qev if m > 0 else 0.0)
                )
                prob = math.exp(logp) if logp > -745.0 else 0.0
                if prob < 1e-14 and (k > 2 or m > 2):
                    break  # tail vanishes monotonically in k (and m)
                wait = np.maximum(
                    0.0,
                    L_eff[j]
                    - base
                    - j * red_pre
                    - k * red_post
                    - (m * red_ev[j] if m > 0 else 0.0),
                )
                num += prob * wait
                den += prob * n_len
                if m > 0:
                    extra_stall += prob * m * L_eff[j]
        # inner `break` only exits the m loop; the k loop breaks on its own
        # via the same vanishing-probability criterion below.
    t_wait_subop = num / den                             # Eq. 12
    t_evict_subop = extra_stall / den if eps > 0 else 0.0

    core = (
        m_per_io * (p.T_mem + p.T_sw)
        + p.E
        + (m_per_io + 2.0) * (t_wait_subop + t_evict_subop)
    )                                                    # Eq. 13
    return p.S * core


def theta_extended_inv(
    L_mem,
    p: OpParams = PAPER_EXAMPLE,
    sysp: SystemParams = PAPER_SYSTEM,
    n_cores: int = 1,
    k_max: int = 120,
) -> np.ndarray:
    """Eq. 14: per-core reciprocal throughput with SSD bandwidth/IOPS caps.

    ``n_cores`` scales the shared-SSD caps: with C cores running in parallel,
    each core may use only 1/C of the SSD bandwidth and IOPS budget.
    """
    rev = theta_prob_inv(L_mem, p, sysp=sysp, k_max=k_max)
    io_bw_cap = p.S * sysp.A_io / (sysp.B_io / n_cores)
    io_ops_cap = p.S / (sysp.R_io / n_cores)
    return np.maximum(rev, np.maximum(io_bw_cap, io_ops_cap))


# ---------------------------------------------------------------------------
# Utilities
# ---------------------------------------------------------------------------

def normalized_throughput(
    inv_fn: Callable[..., np.ndarray],
    L_mem,
    p: OpParams = PAPER_EXAMPLE,
    L_ref: float = 0.1 * US,
    **kw,
) -> np.ndarray:
    """Throughput(L) / Throughput(L_ref) as plotted in Figs. 3 and 11."""
    num = inv_fn(np.asarray([L_ref]), p, **kw)
    return num[0] / inv_fn(L_mem, p, **kw)


def cost_performance_ratio(c: float, b: float, d: float) -> float:
    """Eq. 16: CPR r = (1 - d) / (c*b + (1 - c)).

    c: replaced-DRAM share of server cost, b: relative bit cost of the
    secondary memory, d: throughput degradation it causes. r > 1 means the
    cheaper memory wins.
    """
    return (1.0 - d) / (c * b + (1.0 - c))


def fit_p_tsw_from_memory_only(
    L_mem: np.ndarray, theta: np.ndarray, T_mem: float
) -> tuple[int, float]:
    """Estimate (P, T_sw) from a measured memory-only throughput curve.

    Mirrors the paper's calibration: the flat region gives 1/(T_mem+T_sw),
    the latency-proportional tail gives L/P (Eq. 3).
    """
    inv = 1.0 / np.asarray(theta, dtype=np.float64)
    L = np.asarray(L_mem, dtype=np.float64)
    flat = inv.min()
    t_sw = max(flat - T_mem, 0.0)
    tail = L > 4.0 * (T_mem + t_sw) * 1.0  # comfortably past the knee
    if not np.any(tail):
        return 10, t_sw
    slopes = L[tail] / inv[tail]
    return int(round(float(np.median(slopes)))), t_sw
