"""whisper-small [audio] -- enc-dec, conv frontend stubbed.
[arXiv:2212.04356; unverified]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="encdec",
    n_layers=12,                # 12 encoder + 12 decoder blocks
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab=51865,
    norm_kind="ln",
    mlp_kind="gelu",
    use_rope=False,
    tie_embeddings=True,
    max_positions=32770,        # decoder positions extended for decode_32k
    n_frames=1500,
    citation="arXiv:2212.04356",
).resolve()
