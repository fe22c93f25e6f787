"""End-to-end driver: train a ~100M-parameter dense LM on synthetic data,
on the PyTorch / CUDA port.

The counterpart of ``examples/train_100m.py`` over ``repro_torch``: the same
model (12 layers x 768, vocab 8192, tied embeddings) and schedule, through
data pipeline -> eager train step with the state donated leaf by leaf ->
AdamW -> async checkpointing -> restart-safe loop, on ``--device`` (default
``cuda``).  Resume works: re-running continues from the last checkpoint,
and prints "nothing to do" once ``--steps`` are done.

Run:  PYTHONPATH=src python examples/train_100m_torch.py --steps 300 [--device cpu]
"""
import argparse
import math
import os
import sys
import tempfile
import time

from repro_torch.configs.base import ModelConfig

CFG_100M = ModelConfig(
    name="dense-100m",
    family="dense",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=4,
    d_ff=2048,
    vocab=8192,
    tie_embeddings=True,
).resolve()


def hparams(steps: int):
    """The example's schedule for a run of ``steps`` steps."""
    from repro_torch.train.train_step import TrainHParams
    return TrainHParams(peak_lr=6e-4, warmup=max(steps // 20, 5),
                        total_steps=steps)


def main(argv=None):
    """Returns the metrics of the steps run (``[]``: nothing to do)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_100m_torch_ckpt"))
    ap.add_argument("--device", default="cuda",
                    help="device of the model and the batches (default "
                         "cuda; cpu runs the same code on the host)")
    args = ap.parse_args(argv)
    import torch

    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        sys.exit("train_100m_torch: no CUDA device is available; pass "
                 "--device cpu")

    from repro_torch.roofline.analysis import count_params
    from repro_torch.train.trainer import Trainer
    from repro_torch.zoo import get_api

    cfg = CFG_100M
    n = count_params(get_api(cfg).param_specs(cfg))
    print(f"model: {n/1e6:.1f}M params "
          f"({cfg.n_layers}L x {cfg.d_model}d, vocab {cfg.vocab})")

    tr = Trainer(cfg, hparams(args.steps), ckpt_dir=args.ckpt, ckpt_every=50,
                 device=args.device)
    tr.hp_global_batch, tr.hp_seq_len = args.batch, args.seq

    t0 = time.time()
    state, log = tr.fit(args.steps)
    if not log:
        print("nothing to do (already trained to --steps; delete --ckpt to redo)")
        return log
    losses = [float(m["loss"]) for m in log]       # waits for the card
    wall = time.time() - t0
    tokens = args.batch * args.seq * len(log)
    print(f"\ntrained {len(log)} steps, {tokens/1e3:.0f}k tokens, "
          f"{wall:.0f}s ({tokens/wall:.0f} tok/s on {tr.device.type})")
    k = max(len(log) // 12, 1)
    for i in range(0, len(log), k):
        print(f"  step {i:4d}  loss {losses[i]:6.3f}  "
              f"gnorm {float(log[i]['grad_norm']):6.2f}")
    first = sum(losses[:5]) / min(5, len(log))
    last = sum(losses[-5:]) / min(5, len(log))
    print(f"loss: {first:.3f} -> {last:.3f} "
          f"(floor ~= noise entropy {0.25 * math.log(cfg.vocab):.2f}+)")
    return log


if __name__ == "__main__":
    main()
