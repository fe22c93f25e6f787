"""Training launcher: ``python -m repro_torch.launch.train --arch <id> ...``

Counterpart of ``repro/launch/train.py``, with its arguments and defaults
and one more, ``--device`` (default: the card; ``cpu`` for the host).  Runs
a reduced (smoke, the default) or full (``--full``) config through
:class:`~repro_torch.train.trainer.Trainer` with ``mesh=None``, as the
reference does, and prints about ten of its steps' loss, gradient norm and
wall time.  A sharded run builds ``Trainer(mesh=make_local_mesh())``
itself (:mod:`repro_torch.launch.mesh`).
"""
from __future__ import annotations

import argparse
import os
import tempfile

from ..configs import get_config, list_archs, smoke_config
from ..train.train_step import TrainHParams
from ..train.trainer import Trainer


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--ckpt",
                    default=os.path.join(tempfile.gettempdir(), "repro_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; cpu for the host)")
    return ap


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    hp = TrainHParams(peak_lr=args.lr, warmup=max(args.steps // 10, 1),
                      total_steps=args.steps)
    tr = Trainer(cfg, hp, ckpt_dir=args.ckpt, ckpt_every=args.ckpt_every,
                 device=args.device)
    tr.hp_global_batch = args.batch
    tr.hp_seq_len = args.seq
    state, log = tr.fit(args.steps)
    for i, m in enumerate(log):
        if i % max(len(log) // 10, 1) == 0 or i == len(log) - 1:
            print(f"step {i:5d} loss={float(m.get('loss', 0)):.4f} "
                  f"gnorm={float(m.get('grad_norm', 0)):.3f} "
                  f"wall={m.get('wall', 0):.2f}s")


if __name__ == "__main__":
    main()
