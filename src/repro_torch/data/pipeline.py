"""Tokenized LM data pipeline: deterministic, shardable, resumable.

Counterpart of ``repro/data/pipeline.py``.  Sources: synthetic (seeded
Markov-ish token streams; no external data is fetched) or a binary token
file.  The pipeline is keyed by (step, host_id): any host can
reconstruct its shard of any step, which is what makes restart-and-replay
and elastic re-sharding trivial (the fault-tolerance loop calls
``iterator(start_step)``).  ``DataConfig`` and both generators are the
reference's numpy code, copied verbatim, so their batches are the
reference's arrays bit for bit.

Host->device prefetch: a depth-k queue of asynchronous copies from pinned
host memory -- the same latency-hiding law as everything else in this repo
(the step compute is the "IO" that hides the host-copy "memory access").
"""
from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass
from typing import Iterator

import numpy as np
import torch

from ..core.sim.replay_torch import resolve_device

__all__ = ["DataConfig", "synthetic_batches", "file_batches", "prefetch"]


@dataclass(frozen=True)
class DataConfig:
    global_batch: int
    seq_len: int
    vocab: int
    seed: int = 0
    host_id: int = 0
    n_hosts: int = 1


def _host_slice(cfg: DataConfig) -> tuple[int, int]:
    per = cfg.global_batch // cfg.n_hosts
    return cfg.host_id * per, per


def synthetic_batches(cfg: DataConfig, start_step: int = 0) -> Iterator[dict]:
    """Deterministic synthetic LM batches: order-1 Markov streams whose
    transition structure gives a learnable (non-uniform) distribution."""
    start, per = _host_slice(cfg)
    step = start_step
    while True:
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, cfg.host_id])
        )
        # next-token = affine hash of current + noise: learnable structure
        cur = rng.integers(0, cfg.vocab, (per, 1))
        toks = [cur]
        for _ in range(cfg.seq_len):
            nxt = (toks[-1] * 31 + 17) % cfg.vocab
            noise = rng.integers(0, cfg.vocab, (per, 1))
            take = rng.random((per, 1)) < 0.25
            toks.append(np.where(take, noise, nxt))
        seq = np.concatenate(toks, axis=1).astype(np.int32)
        yield {
            "tokens": seq[:, :-1],
            "targets": seq[:, 1:],
            "loss_mask": np.ones((per, cfg.seq_len), np.float32),
        }
        step += 1


def file_batches(path: str, cfg: DataConfig, start_step: int = 0) -> Iterator[dict]:
    """Binary int32 token file, strided deterministically by (step, host)."""
    data = np.memmap(path, dtype=np.int32, mode="r")
    n_tokens = len(data)
    start, per = _host_slice(cfg)
    span = cfg.seq_len + 1
    n_seqs = n_tokens // span
    step = start_step
    while True:
        rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, step]))
        idx = rng.choice(n_seqs, cfg.global_batch, replace=False)[start : start + per]
        seq = np.stack([data[i * span : (i + 1) * span] for i in idx])
        yield {
            "tokens": seq[:, :-1].astype(np.int32),
            "targets": seq[:, 1:].astype(np.int32),
            "loss_mask": np.ones((per, cfg.seq_len), np.float32),
        }
        step += 1


def _to_device(x, device: torch.device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(x))
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def prefetch(it: Iterator[dict], depth: int = 2, device=None) -> Iterator[dict]:
    """Host->device prefetch queue (depth = the paper's P, once again).

    Each batch's arrays become tensors on ``device`` (``None``: the card,
    ``RuntimeError`` without one; pass ``device="cpu"`` for the host),
    copied from pinned memory without blocking, ``depth`` batches ahead of
    the consumer."""
    return _prefetch(it, depth, resolve_device(device))


def _prefetch(it, depth, device):
    q: deque = deque()
    lock = threading.Lock()

    def put_one():
        try:
            batch = next(it)
        except StopIteration:
            return False
        dev = {k: _to_device(v, device) for k, v in batch.items()}
        with lock:
            q.append(dev)
        return True

    alive = True
    for _ in range(depth):
        alive = put_one() and alive
    while q:
        out = q.popleft()
        if alive:
            alive = put_one()
        yield out
