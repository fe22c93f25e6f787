"""starcoder2-3b [dense] -- GQA, RoPE, LN + GELU FFN. [arXiv:2402.19173; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b",
    family="dense",
    n_layers=30,
    d_model=3072,
    n_heads=24,
    n_kv_heads=2,
    d_ff=12288,
    vocab=49152,
    qkv_bias=True,
    norm_kind="ln",
    mlp_kind="gelu",
    rope_theta=1e5,
    tie_embeddings=True,
    sliding_window=4096,
    citation="arXiv:2402.19173",
).resolve()
