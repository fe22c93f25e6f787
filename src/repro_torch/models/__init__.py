"""The port's model zoo (plain PyTorch): dense GQA transformer, MoE, Mamba-2,
RWKV-6, Zamba2-style hybrid, Whisper-style enc-dec, LLaVA-style VLM, and the
carrying of reference parameter trees (``convert``)."""
from . import (convert, hybrid, layers, mamba2, moe, rwkv6,  # noqa: F401
               transformer, vlm, whisper)
