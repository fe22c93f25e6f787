"""qwen1.5-110b [dense] -- QKV bias, GQA kv=8. [hf:Qwen/Qwen1.5-0.5B; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-110b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=49152,
    vocab=152064,
    qkv_bias=True,
    rope_theta=1e6,
    moment_dtype="bfloat16",
    remat_groups=10,    # ZeRO-sharded moments in bf16 at >=100B
    citation="hf:Qwen/Qwen1.5-0.5B",
).resolve()
