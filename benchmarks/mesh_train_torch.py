"""qwen2.5-3b at full width trained through ``Trainer(mesh=...)`` on N ranks
under torchrun, one card a rank::

    python -m torch.distributed.run --standalone --nproc-per-node 4 \\
        benchmarks/mesh_train_torch.py [--data 2 --model 2]

``--device cpu --smoke`` runs the smoke config on the host over gloo (B 4 x
S 96).  The model, seed, hyper-parameters and B 2 x S 2048 are
``chip_smoke.py``'s ``train_path``'s, so the losses stand beside its own.
Rank 0 prints one JSON line: the card's name and power limit (as
``nvidia-smi`` gives them), losses, grad norms, step seconds, each rank's
peak allocated bytes, and on the card one more step under
``torch.profiler`` on every rank: rank 0's kernel seconds and idle share.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro_torch.configs import ARCHS, smoke_config  # noqa: E402
from repro_torch.launch.mesh import make_local_mesh  # noqa: E402
from repro_torch.train.train_step import TrainHParams  # noqa: E402
from repro_torch.train.trainer import Trainer  # noqa: E402


def _profiled_step(tr, state, batch) -> dict:
    """One more step under ``torch.profiler`` (every rank steps; each
    profiles its own card): wall s, kernel s and the idle share."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    dist.barrier()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        tr.train_step(state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = sum(getattr(ev, "self_device_time_total", 0)
               for ev in prof.key_averages()
               if ev.device_type == torch.autograd.DeviceType.CUDA) / 1e6
    return {"wall_s": wall, "device_kernel_s": busy,
            "device_idle_share": 1.0 - busy / wall if busy else None}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; cpu for gloo)")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--data", type=int, default=2)
    ap.add_argument("--model", type=int, default=2)
    args = ap.parse_args(argv)
    ranks = int(os.environ.get("WORLD_SIZE", 1))
    torch.set_num_threads(max(1, (os.cpu_count() or 4) // ranks))
    cfg, B, S = ARCHS["qwen2.5-3b"], 2, 2048
    if args.smoke:
        cfg, B, S = smoke_config(cfg), 4, 96
    mesh = make_local_mesh(args.data, args.model, device=args.device)
    hp = TrainHParams(peak_lr=3e-4, warmup=1, total_steps=6)
    tr = Trainer(cfg, hp, mesh=mesh, ckpt_dir="build/mesh_train_ckpt",
                 ckpt_every=0, seed=0)
    tr.hp_global_batch, tr.hp_seq_len = B, S
    cuda = tr.device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    state = tr.init_state()
    data = tr.data_iter(0)
    step_s, losses, gnorms = [], [], []
    for _ in range(args.steps):
        batch = next(data)
        sync()
        dist.barrier()
        t0 = time.perf_counter()
        state, m = tr.train_step(state, batch)
        sync()
        dist.barrier()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
    peaks = [None] * dist.get_world_size()
    dist.all_gather_object(
        peaks, torch.cuda.max_memory_allocated() if cuda else None)
    profile = _profiled_step(tr, state, next(data)) if cuda else None
    if dist.get_rank() == 0:
        warm = sorted(step_s[1:])
        card = (subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines() if cuda else [])
        print(json.dumps({
            "world": dist.get_world_size(), "mesh": [args.data, args.model],
            "device": torch.cuda.get_device_name(0) if cuda else "cpu",
            "cards": card, "profiled_step": profile,
            "B": B, "S": S, "loss": losses, "grad_norm": gnorms,
            "step_s": step_s,
            "median_step_s_2_on": warm[len(warm) // 2] if warm else None,
            "peak_allocated_bytes_by_rank": peaks}), flush=True)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
