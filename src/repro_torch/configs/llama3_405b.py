"""llama3-405b [dense] -- GQA kv=8, 128k vocab. [arXiv:2407.21783; unverified]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b",
    family="dense",
    n_layers=126,
    d_model=16384,
    n_heads=128,
    n_kv_heads=8,
    d_ff=53248,
    vocab=128256,
    rope_theta=5e5,
    moment_dtype="bfloat16",
    remat_groups=14,
    citation="arXiv:2407.21783",
).resolve()
