"""Serve a small model with batched requests over the tiered paged KV cache,
on the PyTorch / CUDA port.

The counterpart of ``examples/serve_tiered_kv.py`` over ``repro_torch``:
the same smoke config and request stream through
``repro_torch.serve.ServeEngine`` on ``--device`` (default ``cuda``).  The
page store is the "microsecond-latency memory" of the paper; on the card,
decode attention reaches it only through the paged CUDA kernel (one launch
a layer a decode step), and the prefetch depth is sized by the paper's
Theta model for the configured tier latency.

Run:  PYTHONPATH=src python examples/serve_tiered_kv_torch.py [--device cpu]
"""
import argparse
import dataclasses
import sys
import time

import numpy as np


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="device of the model and the page store (default "
                         "cuda; cpu runs the plain PyTorch versions)")
    dev = ap.parse_args(argv).device
    import torch

    if torch.device(dev).type == "cuda" and not torch.cuda.is_available():
        sys.exit("serve_tiered_kv_torch: no CUDA device is available; pass "
                 "--device cpu")

    from repro_torch.configs import ARCHS, smoke_config
    from repro_torch.core.tiering import CXL_MICROSECOND, TPU_HOST
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = smoke_config(ARCHS["qwen2.5-3b"]).replace(sliding_window=None)
    eng = ServeEngine(cfg, n_pages=128, page_size=8, max_slots=4, seed=0,
                      device=dev)

    rng = np.random.default_rng(0)
    reqs = [
        Request(rid=i, prompt=rng.integers(
            1, cfg.vocab, rng.integers(4, 20)).astype(np.int32),
            max_new_tokens=8)
        for i in range(10)
    ]
    for r in reqs:
        eng.submit(r)

    t0 = time.time()
    done = eng.run(max_steps=400)
    wall = time.time() - t0
    tokens = sum(len(r.out_tokens) for r in done)
    print(f"served {len(done)} requests, {tokens} tokens in {eng.steps} "
          f"engine steps ({wall:.1f}s on {eng.device.type})")
    print(f"page utilization at end: {eng.cache.utilization:.0%} "
          f"(all pages released: "
          f"{len(eng.cache.free) == eng.cache.cfg.n_pages})")

    # model-driven prefetch depth for two slow-tier choices
    eng.cache.admit(999, 64)
    for tier in (TPU_HOST, CXL_MICROSECOND):
        eng.cache.cfg = dataclasses.replace(eng.cache.cfg, tier=tier)
        depth = eng.cache.plan_prefetch_depth(t_page_compute=2e-6,
                                              t_step_other=30e-6)
        print(f"planned DMA prefetch depth for {tier.name} "
              f"(L={tier.latency * 1e6:.1f}us): P={depth}")
    eng.cache.release(999)
    print("first request sample output:", done[0].out_tokens)
    if len(done) != len(reqs) or any(len(r.out_tokens) != r.max_new_tokens
                                     for r in reqs):
        sys.exit("serve_tiered_kv_torch: not every request was served in "
                 "full")


if __name__ == "__main__":
    main()
