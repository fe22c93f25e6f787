"""Model-driven sizing of latency-hiding resources.

The paper sizes user-level-thread counts empirically ("try different numbers
of threads and report the highest"). The closed-form model lets us *plan*
instead: given operation parameters and a memory tier, pick

  * the number of concurrent operations (threads / decode slots) N,
  * the prefetch depth (in-flight fetches / staging buffers) P,

that reach a target fraction of the latency-hidden plateau. The serving
engine uses the same planner to size its KV-page prefetch pipeline: there,
T_mem is the per-page compute time, T_io the per-step "other work"
(attention FLOPs, collectives), and L_mem the slow-tier fetch latency.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np

from .latency_model import OpParams, theta_multi_inv, theta_prob_inv
from .tiering import MemoryTier

__all__ = ["Plan", "plan_concurrency", "plan_pipeline_depth"]


@dataclass(frozen=True)
class Plan:
    n_threads: int
    prefetch_depth: int
    predicted_inv: float          # expected seconds per operation
    plateau_inv: float            # best achievable seconds per operation
    efficiency: float             # plateau_inv / predicted_inv


def plan_concurrency(
    p: OpParams,
    L_mem: float,
    target: float = 0.98,
    n_max: int = 4096,
) -> int:
    """Smallest N with Theta_multi within ``target`` of the N->inf plateau.

    Little's-law sizing (Eq. 2): N >= (T_mem + L_mem) / (T_mem + T_sw).
    """
    plateau = p.T_mem + p.T_sw
    for n in range(1, n_max + 1):
        inv = theta_multi_inv(np.asarray([L_mem]), replace(p, N=n))[0]
        if plateau / inv >= target:
            return n
    return n_max


def plan_pipeline_depth(
    p: OpParams,
    L_mem: float,
    p_max: int = 64,
    target: float = 0.98,
) -> Plan:
    """Smallest prefetch depth P whose Theta_prob reaches ``target`` of the
    P->inf plateau at latency ``L_mem``.

    On TPU this is the number of VMEM staging buffers the paged-KV pipeline
    allocates: more buffers hide more latency but eat VMEM, so we want the
    knee, not the max (Eq. 8 says the knee moves out by P*E/M thanks to the
    compute that plays the role of IO).
    """
    m_per_io = p.M / p.S
    plateau = p.S * (m_per_io * (p.T_mem + p.T_sw) + p.E)
    best = None
    for depth in range(1, p_max + 1):
        inv = theta_prob_inv(np.asarray([L_mem]), replace(p, P=depth))[0]
        eff = plateau / inv
        best = Plan(
            n_threads=plan_concurrency(p, L_mem),
            prefetch_depth=depth,
            predicted_inv=float(inv),
            plateau_inv=float(plateau),
            efficiency=float(eff),
        )
        if eff >= target:
            return best
    assert best is not None
    return best


def plan_for_tier(p: OpParams, tier: MemoryTier, **kw) -> Plan:
    return plan_pipeline_depth(p, tier.latency, **kw)
