"""Architecture registry: the ten assigned configs, selectable by ``--arch``."""
from __future__ import annotations

from .base import SHAPES, ModelConfig, Shape, smoke_config  # noqa: F401

from . import (  # noqa: E402
    deepseek_moe_16b,
    llama3_405b,
    llava_next_mistral_7b,
    qwen1_5_110b,
    qwen2_5_3b,
    qwen2_moe_a2_7b,
    rwkv6_3b,
    starcoder2_3b,
    whisper_small,
    zamba2_7b,
)

ARCHS: dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (
        llava_next_mistral_7b,
        qwen2_5_3b,
        starcoder2_3b,
        qwen1_5_110b,
        llama3_405b,
        deepseek_moe_16b,
        qwen2_moe_a2_7b,
        zamba2_7b,
        rwkv6_3b,
        whisper_small,
    )
}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]


def list_archs() -> list[str]:
    return list(ARCHS)


def shape_applicable(cfg: ModelConfig, shape: Shape) -> tuple[bool, str]:
    """Whether an (arch, shape) cell runs, and why not if it doesn't.

    long_500k needs sub-quadratic attention: it runs for SSM/hybrid archs and
    for sliding-window transformers (O(window) ring cache); it is skipped for
    pure full-attention archs. Enc-dec has no 500k decode either.
    """
    if shape.name == "long_500k":
        if cfg.family == "encdec":
            return False, "enc-dec: 500k autoregressive decode not architecturally meaningful"
        if cfg.family in ("ssm", "hybrid"):
            return True, ""
        if cfg.sliding_window is not None:
            return True, ""
        return False, "pure full attention: O(seq) KV at 500k is not sub-quadratic"
    return True, ""


def shape_config(cfg: ModelConfig, shape: Shape) -> ModelConfig:
    """Per-shape config adjustments (documented in DESIGN.md SS5)."""
    if shape.name == "long_500k" and cfg.family == "hybrid":
        # zamba2's shared attention runs sliding-window at 500k context
        return cfg.replace(sliding_window=4096)
    if shape.kind == "prefill" and shape.seq_len > 8192:
        # larger flash blocks for long prefill
        return cfg.replace(attn_block_kv=2048)
    return cfg
