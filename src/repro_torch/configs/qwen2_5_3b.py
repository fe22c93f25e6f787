"""qwen2.5-3b [dense] -- GQA, QKV bias. [hf:Qwen/Qwen2.5-0.5B; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-3b",
    family="dense",
    n_layers=36,
    d_model=2048,
    n_heads=16,
    n_kv_heads=2,
    d_ff=11008,
    vocab=151936,
    qkv_bias=True,
    rope_theta=1e6,
    tie_embeddings=True,
    citation="hf:Qwen/Qwen2.5-0.5B",
).resolve()
