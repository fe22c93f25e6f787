"""LLaVA-NeXT-style VLM: Mistral-7B backbone + projected patch embeddings,
plain PyTorch.

Counterpart of ``repro/models/vlm.py``.  The vision tower is a stub:
callers pass precomputed anyres patch embeddings (B, n_patches,
vision_dim); this module owns only the multimodal projector (vision_dim ->
d_model, a two-layer GELU MLP with the tanh approximation, the
reference's GELU) and defers everything else to the dense
transformer.  Sequence layout is [patches | text].
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import transformer as tf
from .layers import DTYPE, ParamSpec

__all__ = ["param_specs", "forward", "decode_step", "init_cache", "project_patches"]


def param_specs(cfg) -> dict:
    sp = tf.param_specs(cfg)
    sp["projector"] = {
        "w1": ParamSpec((cfg.vision_dim, cfg.d_model), (None, "embed")),
        "b1": ParamSpec((cfg.d_model,), ("embed",), init="zeros"),
        "w2": ParamSpec((cfg.d_model, cfg.d_model), ("embed", "embed2")),
        "b2": ParamSpec((cfg.d_model,), ("embed",), init="zeros"),
    }
    return sp


def project_patches(params, patches: torch.Tensor) -> torch.Tensor:
    """(B, n_patches, vision_dim) -> (B, n_patches, d_model)."""
    p = params["projector"]
    h = patches.to(DTYPE) @ p["w1"] + p["b1"]
    h = F.gelu(h.float(), approximate="tanh").to(DTYPE)
    return h @ p["w2"] + p["b2"]


def forward(params, tokens, cfg, patches=None, remat: bool = True,
            last_only: bool = False):
    prefix = project_patches(params, patches) if patches is not None else None
    return tf.forward(params, tokens, cfg, prefix_embeds=prefix, remat=remat,
                      last_only=last_only)


init_cache = tf.init_cache
decode_step = tf.decode_step
