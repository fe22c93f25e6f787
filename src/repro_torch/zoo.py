"""Uniform API over the port's model zoo: one dispatch point per
architecture, as ``repro/zoo.py``.

Every family exposes the same four entry points through :func:`get_api`:

  * ``param_specs(cfg)``                          -> ParamSpec tree
  * ``logits(params, batch, cfg)``                -> (logits, aux_loss)
  * ``init_cache(cfg, batch, max_len, device=None)`` -> decode cache/state
  * ``decode(params, cache, tokens, cfg)``        -> (logits, new cache)

``batch`` is a dict with 'tokens' (B, S_text) plus optional 'patches'
(VLM stub) / 'frames' (audio stub).  ``init_cache`` puts the cache on
``device`` (``None``: the card, ``RuntimeError`` without one; pass
``device="cpu"`` for the host); the ssm family ignores ``max_len`` and the
encdec family adds ``cfg.n_frames`` cross-attention slots, as in the
reference.  ``logits(..., remat=True)`` recomputes each layer in the
backward (training, :mod:`repro_torch.train`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from .models import hybrid, moe, rwkv6, transformer, vlm, whisper

__all__ = ["ArchAPI", "get_api"]


@dataclass(frozen=True)
class ArchAPI:
    param_specs: Callable[[Any], dict]
    logits: Callable[..., tuple]
    init_cache: Callable[..., Any]
    decode: Callable[..., tuple]


def _zero_aux(logits):
    return logits, torch.zeros((), dtype=torch.float32, device=logits.device)


def _dense_api() -> ArchAPI:
    return ArchAPI(
        param_specs=transformer.param_specs,
        logits=lambda p, b, cfg, remat=True: _zero_aux(
            transformer.forward(p, b["tokens"], cfg, remat=remat)
        ),
        init_cache=transformer.init_cache,
        decode=transformer.decode_step,
    )


def _moe_api() -> ArchAPI:
    return ArchAPI(
        param_specs=moe.param_specs,
        logits=lambda p, b, cfg, remat=True: moe.forward(
            p, b["tokens"], cfg, remat=remat
        ),
        init_cache=moe.init_cache,
        decode=moe.decode_step,
    )


def _vlm_api() -> ArchAPI:
    return ArchAPI(
        param_specs=vlm.param_specs,
        logits=lambda p, b, cfg, remat=True: _zero_aux(
            vlm.forward(p, b["tokens"], cfg, patches=b.get("patches"), remat=remat)
        ),
        init_cache=vlm.init_cache,
        decode=vlm.decode_step,
    )


def _hybrid_api() -> ArchAPI:
    return ArchAPI(
        param_specs=hybrid.param_specs,
        logits=lambda p, b, cfg, remat=True: _zero_aux(
            hybrid.forward(p, b["tokens"], cfg, remat=remat)
        ),
        init_cache=hybrid.init_cache,
        decode=hybrid.decode_step,
    )


def _ssm_api() -> ArchAPI:
    return ArchAPI(
        param_specs=rwkv6.param_specs,
        logits=lambda p, b, cfg, remat=True: _zero_aux(
            rwkv6.forward(p, b["tokens"], cfg, remat=remat)
        ),
        init_cache=lambda cfg, batch, max_len, device=None: rwkv6.init_state(
            cfg, batch, device=device),
        decode=rwkv6.decode_step,
    )


def _encdec_api() -> ArchAPI:
    return ArchAPI(
        param_specs=whisper.param_specs,
        logits=lambda p, b, cfg, remat=True: _zero_aux(
            whisper.forward(p, b["tokens"], cfg, frames=b["frames"], remat=remat)
        ),
        init_cache=lambda cfg, batch, max_len, device=None: whisper.init_cache(
            cfg, batch, max_len, cfg.n_frames, device=device
        ),
        decode=whisper.decode_step,
    )


_FAMILIES = {
    "dense": _dense_api,
    "moe": _moe_api,
    "vlm": _vlm_api,
    "hybrid": _hybrid_api,
    "ssm": _ssm_api,
    "encdec": _encdec_api,
}


def get_api(cfg) -> ArchAPI:
    return _FAMILIES[cfg.family]()
