"""Model configuration dataclass + the four assigned input shapes."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | hybrid | ssm | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0              # 0 -> d_model // n_heads
    # attention / block options
    qkv_bias: bool = False
    norm_kind: str = "rms"         # rms | ln
    mlp_kind: str = "swiglu"       # swiglu | gelu
    tie_embeddings: bool = False
    use_rope: bool = True
    rope_theta: float = 1e4
    sliding_window: int | None = None
    causal: bool = True
    attn_block_kv: int = 1024
    # MoE
    n_experts: int = 0
    n_shared: int = 0
    top_k: int = 0
    d_expert: int = 0
    capacity_factor: float = 1.25
    moe_groups: int = 32           # dispatch groups (align with data shards)
    # SSM / hybrid
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    ssm_chunk: int = 128
    attn_every: int = 0            # hybrid: shared attn at every k-th layer
    # RWKV
    rwkv_head_dim: int = 64
    # enc-dec
    max_positions: int = 0         # decoder learned-position table (0 = unused)
    n_frames: int = 1500           # stub audio frontend output length
    # VLM
    vision_dim: int = 1152
    n_patches: int = 0             # stub patch-embedding prefix length
    # lowering/analysis
    unroll_inner: int = 0        # unroll cap for attention/SSM chunk loops (metric lowering)
    unroll_layers: bool = False  # unroll layer/microbatch scans (metric lowering)
    remat_groups: int = 0        # 2-level (sqrt) activation remat: outer scan groups
    # training numerics
    moment_dtype: str = "float32"  # bf16 for the >=100B configs (memory)
    citation: str = ""

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def n_rwkv_heads(self) -> int:
        return self.d_model // self.rwkv_head_dim

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def resolve(self) -> "ModelConfig":
        return self.replace(head_dim=self.head_dim_)


@dataclass(frozen=True)
class Shape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES: dict[str, Shape] = {
    "train_4k": Shape("train_4k", 4096, 256, "train"),
    "prefill_32k": Shape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": Shape("decode_32k", 32768, 128, "decode"),
    "long_500k": Shape("long_500k", 524288, 1, "decode"),
}


def smoke_config(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    kw = dict(
        n_layers=min(cfg.n_layers, 4 if cfg.family != "hybrid" else 7),
        d_model=128,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4,
        d_ff=256,
        vocab=512,
        head_dim=32,
        attn_block_kv=64,
        ssm_chunk=16,
        max_positions=512 if cfg.max_positions else 0,
        n_frames=24 if cfg.family == "encdec" else cfg.n_frames,
        sliding_window=64 if cfg.sliding_window else None,
        vision_dim=48 if cfg.family == "vlm" else cfg.vision_dim,
        n_patches=8 if cfg.family == "vlm" else 0,
    )
    if cfg.family == "moe":
        kw.update(n_experts=8, n_shared=min(cfg.n_shared, 2), top_k=2, d_expert=64)
    if cfg.family in ("hybrid", "ssm"):
        kw.update(ssm_state=16, ssm_head_dim=32, rwkv_head_dim=32)
    if cfg.family == "hybrid":
        kw.update(attn_every=3)
    return cfg.replace(**kw).resolve()
