"""deepseek-moe-16b [moe] -- 2 shared + 64 routed top-6, fine-grained.
[arXiv:2401.06066; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab=102400,
    n_experts=64,
    n_shared=2,
    top_k=6,
    d_expert=1408,
    citation="arXiv:2401.06066",
).resolve()
