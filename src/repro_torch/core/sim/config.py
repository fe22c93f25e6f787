"""Simulation configuration and result types (the paper's free parameters)."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence

from ..trace_ir import US

__all__ = ["US", "DEFAULT_THREAD_CANDIDATES", "SimConfig", "SimResult"]

# The thread counts tried when optimizing per latency point -- shared by the
# legacy best_over_threads protocol and the batched sweep pipeline so the
# two always search the same grid.
DEFAULT_THREAD_CANDIDATES = (8, 16, 24, 32, 48, 64, 96, 128)


@dataclass(frozen=True)
class SimConfig:
    # Core/thread structure
    n_threads: int = 48
    n_cores: int = 1
    T_sw: float = 0.05 * US
    # Prefetch path
    P: int = 12
    L_mem: float | Sequence[tuple[float, float]] = 5.0 * US  # scalar or [(lat, prob)]
    rho: float = 1.0
    L_dram: float = 0.1 * US
    eps: float = 0.0
    A_mem: float = 64.0
    B_mem: float = 0.0            # bytes/sec; 0 disables the throttle
    # IO path
    L_io: float = 80.0 * US
    L_io_jitter: float = 0.25     # uniform +-fraction of L_io (real SSDs jitter;
                                  # this is what naturally misaligns threads,
                                  # Sec. 3.2.2 "timing ... will be mostly random")
    A_io: float = 1024.0
    B_io: float = 0.0             # 0 disables; per device when n_ssd > 1
    R_io: float = 0.0             # 0 disables; per device when n_ssd > 1
    n_ssd: int = 1                # SSDs behind the IO path, each with its own
                                  # IOPS/bandwidth token clocks; IOs are striped
                                  # round-robin in submission order
    L_switch: float = 0.0         # CXL/PCIe-switch fan-out hop added to every
                                  # IO when the device pool hangs off a switch
    io_degrade: float = 1.0       # L_io multiplier for IOs submitted at
                                  # now >= T_degrade (1.0 disables) -- models a
                                  # device whose clocks slow mid-run (a failing
                                  # SSD, a GC storm, a degraded cluster node)
    T_degrade: float = 0.0        # virtual-time onset (seconds) of io_degrade;
                                  # 0.0 degrades the whole run
    # Contention
    T_lock: float = 0.0
    seed: int = 0
    collect_load_hist: bool = False

    def __post_init__(self):
        if self.n_cores < 1:
            raise ValueError(f"n_cores must be >= 1, got {self.n_cores}")
        if self.n_threads < 1:
            raise ValueError(f"n_threads must be >= 1, got {self.n_threads}")
        if self.T_lock < 0:
            raise ValueError(f"T_lock must be >= 0, got {self.T_lock}")
        if self.io_degrade <= 0:
            raise ValueError(
                f"io_degrade must be > 0, got {self.io_degrade}")
        if self.T_degrade < 0:
            raise ValueError(
                f"T_degrade must be >= 0, got {self.T_degrade}")


@dataclass
class SimResult:
    ops: int
    time: float                     # virtual seconds elapsed
    throughput: float               # ops/sec
    mem_stall_total: float          # total prefetch-wait (gray-bar) seconds
    mem_accesses: int
    op_latencies: list[float] = field(default_factory=list)
    load_stalls: list[float] = field(default_factory=list)  # Fig. 10 histogram
    # Open-loop tail-latency extras (see repro_torch.core.sim.arrivals): measured
    # ops whose sojourn blew the SLA deadline, and the per-cell percentile
    # summary (an arrivals.LatencySummary) when collect_percentiles was on.
    missed_ops: int = 0
    latency_summary: object | None = None

    @property
    def mean_op_latency(self) -> float:
        return sum(self.op_latencies) / max(len(self.op_latencies), 1)
