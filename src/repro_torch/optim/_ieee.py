"""A correctly rounded float32 square root on every device.

PyTorch's float32 ``sqrt`` on the CPU (its vectorized AVX-512 path) is not
correctly rounded: it is one ulp off for about 0.7 % of inputs, where XLA's
and CUDA's ``sqrtf`` round correctly.  On the CPU the root is taken in
float64 and rounded once to float32, which is the correctly rounded float32
root (double rounding is innocuous for the square root when the wider format
has at least 2 * 24 + 2 bits).
"""
from __future__ import annotations

import torch


def sqrt(x: torch.Tensor) -> torch.Tensor:
    if x.device.type == "cpu" and x.dtype == torch.float32:
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x)
