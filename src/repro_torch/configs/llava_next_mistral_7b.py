"""llava-next-mistral-7b [vlm] -- anyres tiling, Mistral-7B backbone.
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=32000,
    rope_theta=1e6,
    sliding_window=4096,        # Mistral-v0.1 SWA; enables long_500k ring cache
    vision_dim=1152,
    n_patches=2880,             # anyres: 576 base + 4 x 576 tiles (stub)
    citation="hf:llava-hf/llava-v1.6-mistral-7b-hf",
).resolve()
