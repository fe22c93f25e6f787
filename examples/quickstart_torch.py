"""Quickstart on the PyTorch / CUDA port: the three layers of this repo.

The counterpart of ``examples/quickstart.py`` over ``repro_torch``:

  1. the paper's analytical model (closed form),
  2. the discrete-event "FPGA testbed" simulator validating it,
  3. the model stack: one train step of a tiny LM, and decode attention
     over a paged KV store through the paged CUDA kernel on the card (its
     plain PyTorch version with ``--device cpu``).

Run:  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse
import sys

import numpy as np


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="device of part 3 (default cuda; cpu runs the "
                         "plain PyTorch versions)")
    dev = ap.parse_args(argv).device
    import torch

    if torch.device(dev).type == "cuda" and not torch.cuda.is_available():
        sys.exit("quickstart_torch: no CUDA device is available; pass "
                 "--device cpu")

    from repro_torch.configs import ARCHS, smoke_config
    from repro_torch.core.latency_model import (
        US, PAPER_EXAMPLE, lstar_best, lstar_mem, theta_mask_inv,
        theta_prob_inv,
    )
    from repro_torch.core.sim import (SimConfig, best_over_threads,
                                      microbenchmark_source)
    from repro_torch.kernels.ops import paged_decode_attention
    from repro_torch.models.layers import init_params
    from repro_torch.train.train_step import (TrainHParams, init_train_state,
                                              make_train_step)
    from repro_torch.zoo import get_api

    print("=== 1. the paper's model ===")
    p = PAPER_EXAMPLE
    print(f"memory-only tolerated latency L* = {lstar_mem(p)/US:.1f} us (Eq. 4)")
    print(f"with IO                       L* = {lstar_best(p)/US:.1f} us (Eq. 8)")
    for L in (1, 5, 10):
        mask = 1 / theta_mask_inv(np.array([L * US]))[0]
        prob = 1 / theta_prob_inv(np.array([L * US]))[0]
        print(f"L_mem={L:2d}us: masking-only {mask/1e3:6.1f} kops/s, "
              f"probabilistic {prob/1e3:6.1f} kops/s")

    print("\n=== 2. the simulator agrees (O3) ===")
    src = microbenchmark_source(10, p.T_mem, p.T_io_pre, p.T_io_post)
    for L in (1, 5):
        r, n = best_over_threads(SimConfig(L_mem=L * US, P=10), src, 4000)
        prob = 1 / theta_prob_inv(np.array([L * US]))[0]
        print(f"L_mem={L}us: simulated {r.throughput/1e3:6.1f} kops/s "
              f"(model {prob/1e3:6.1f}, best N={n})")

    print("\n=== 3. the framework: one train step of a tiny qwen2.5 ===")
    cfg = smoke_config(ARCHS["qwen2.5-3b"])
    api = get_api(cfg)
    hp = TrainHParams(total_steps=10, warmup=1)
    step = make_train_step(api, cfg, hp)
    params = init_params(api.param_specs(cfg),
                         torch.Generator(dev).manual_seed(0))
    state = init_train_state(params, hp)
    t = np.random.default_rng(1).integers(0, cfg.vocab, (4, 33))
    t = torch.from_numpy(t.astype(np.int32)).to(dev)
    batch = {"tokens": t[:, :-1], "targets": t[:, 1:],
             "loss_mask": torch.ones((4, 32), device=dev)}
    state, metrics = step(state, batch)
    print(f"loss={float(metrics['loss']):.3f} (ln V = {np.log(cfg.vocab):.3f})")

    print("\n=== 3b. paged decode through the DMA-prefetch kernel ===")
    B, Hq, Hkv, D, page, ppseq = 2, 4, 2, 32, 8, 4
    gen = torch.Generator(dev).manual_seed(2)
    kp = torch.randn((32, page, Hkv, D), generator=gen, device=dev)
    vp = torch.randn((32, page, Hkv, D), generator=gen, device=dev)
    bt = torch.arange(B * ppseq, dtype=torch.int32, device=dev).reshape(
        B, ppseq)
    q = torch.randn((B, Hq, D), generator=gen, device=dev)
    out = paged_decode_attention(q, kp, vp, bt, torch.tensor(
        [20, 30], dtype=torch.int32, device=dev))
    print(f"paged attention out shape {tuple(out.shape)}, "
          f"finite={bool(torch.isfinite(out).all())} (on {out.device.type})")
    if not bool(torch.isfinite(out).all()) or \
            not bool(torch.isfinite(metrics["loss"])):
        sys.exit("quickstart_torch: a non-finite result")
    print("\nquickstart OK")


if __name__ == "__main__":
    main()
