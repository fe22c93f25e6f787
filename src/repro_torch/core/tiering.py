"""Memory-tier descriptors shared by the simulator, planner and serving engine.

The paper's Figure 1(b) spectrum, plus the TPU-side tiers the serving engine
uses. Latencies/bandwidths are per-device defaults and freely overridable --
the whole point of the paper (and of this framework's planner) is that the
*law* relating latency to throughput is what matters, not one device's spec.
"""
from __future__ import annotations

from dataclasses import dataclass

US = 1e-6

__all__ = ["MemoryTier", "DRAM", "CXL_EXPANDER", "CXL_MICROSECOND", "FLASH_CXL",
           "TPU_HBM", "TPU_HOST", "SSD", "tail_mixture"]


@dataclass(frozen=True)
class MemoryTier:
    name: str
    latency: float                    # seconds, average
    bandwidth: float                  # bytes/sec per device
    bit_cost: float                   # $/GB relative to DRAM (=1.0)
    tail: tuple[tuple[float, float], ...] = ()  # [(latency, prob)] overrides

    def latency_spec(self):
        """Latency in the simulator's scalar-or-mixture format."""
        return list(self.tail) if self.tail else self.latency


DRAM = MemoryTier("dram", 0.1 * US, 38e9, 1.0)
CXL_EXPANDER = MemoryTier("cxl-dram", 0.3 * US, 28e9, 0.9)
CXL_MICROSECOND = MemoryTier("cxl-usec", 5.0 * US, 10e9, 0.18)
# Low-latency-flash CXL with the paper's Sec. 5.1 tail profile:
# 5 us (90%), 14 us (9.9%), 48 us (0.1%) -- fit to a Samsung Z-SSD-like curve.
FLASH_CXL = MemoryTier(
    "flash-cxl", 5.0 * US, 10e9, 0.18,
    tail=((5.0 * US, 0.90), (14.0 * US, 0.099), (48.0 * US, 0.001)),
)
TPU_HBM = MemoryTier("tpu-hbm", 0.5 * US, 819e9, 4.0)
TPU_HOST = MemoryTier("tpu-host", 3.0 * US, 50e9, 1.0)   # over PCIe, DMA-visible
SSD = MemoryTier("ssd", 80.0 * US, 10e9, 0.02)


def tail_mixture(mean: float, tail_lat: float, tail_prob: float):
    """Two-point latency mixture with a given mean and tail."""
    base = (mean - tail_prob * tail_lat) / (1.0 - tail_prob)
    return [(base, 1.0 - tail_prob), (tail_lat, tail_prob)]
