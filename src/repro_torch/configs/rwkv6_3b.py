"""rwkv6-3b "Finch" [ssm] -- attention-free, data-dependent decay.
[arXiv:2404.05892; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    n_layers=32,
    d_model=2560,
    n_heads=40,                 # bookkeeping only; attn-free
    n_kv_heads=40,
    d_ff=8960,
    vocab=65536,
    use_rope=False,
    rwkv_head_dim=64,
    ssm_chunk=32,
    citation="arXiv:2404.05892",
).resolve()
