"""Multi-pod dry run: count every (arch x shape x mesh) cell on its mesh.

Counterpart of ``repro/launch/dryrun.py``.  For each cell this runs the
real step function (the train step with AdamW, prefill, or decode) once
under ``FakeTensorMode``, on a fake process group of the production mesh's
world (256 or 512 ranks; this process is rank 0 and no collective moves
data), so nothing is allocated and no card is needed.  One rank's ops are
counted by :class:`~repro_torch.roofline.analysis.OpCounter`, which records

  * FLOPs and bytes (every op's, and the matmul class's),
  * the collectives by kind, with their counts and link bytes,
  * per-device memory: the local bytes of the arguments plus the peak of
    live temporaries,
  * the derived roofline terms (:class:`~repro_torch.roofline.analysis.RooflineTerms`).

The layer stack and the microbatch loop are Python loops, so every layer
is counted; :func:`_fit_metrics` keeps the full-depth cells cheap on the
host by counting a few shallow variants and extrapolating (layers are
identical by construction).  A failed cell is a ``fail`` row, a result.

The process owns its process group (the fake one): run it as a program of
its own.  ``--device`` is the device type the mesh and the fake tensors
claim (default: the card, raising without one; ``--device cpu`` on the
host).  On a ``cpu`` mesh DTensor replaces an all-to-all by an all-gather
and a chunk, so a CPU count of the MoE cells reports another collective
mix than the card's: every row names its ``device``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-3b \\
      --shape train_4k --mesh single --device cpu
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all \\
      --mesh both --device cpu
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback

import torch

from ..configs import SHAPES, list_archs
from ..distributed.sharding import place_
from ..models.layers import map_tree
from ..roofline.analysis import (
    OpCounter,
    RooflineTerms,
    active_params,
    collective_bytes,
    count_params,
    dot_bytes,
    model_flops,
)
from ..tree import leaves
from ..zoo import get_api
from .mesh import make_production_mesh
from .specs import default_microbatches, make_cell

__all__ = ["fake_world", "count_cell", "run_cell", "main"]

_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
          "collective-permute")
_FIT_KEYS = ("flops", "bytes", "dot_bytes", "coll_total", "coll_all-gather",
             "coll_all-reduce", "coll_reduce-scatter", "coll_all-to-all",
             "coll_collective-permute")


def _device_type(device) -> str:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "the dry run counts for the card by default and none is "
                "available; pass --device cpu to count on the host")
        return "cuda"
    return torch.device(device).type


def fake_world(world: int) -> None:
    """Make this process rank 0 of a fake process group of ``world`` ranks
    (replacing any fake group it had)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


@contextlib.contextmanager
def _strided_bookkeeping():
    """DTensor computes a ``_StridedShard``'s local size and offsets with
    tensors of its own (``torch.arange`` + ``tolist``); under
    ``FakeTensorMode`` those are fake and ``tolist`` has no data (it raises
    ``aten._local_scalar_dense``).  They run outside the fake mode here;
    with real tensors DTensor needs nothing of this."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import placement_types as pt

    cls = getattr(pt, "_StridedShard", None)
    orig = getattr(cls, "local_shard_size_and_offset", None)
    if orig is None:
        yield
        return

    def real(*args, **kwargs):
        with unset_fake_temporarily():
            return orig(*args, **kwargs)

    cls.local_shard_size_and_offset = real
    try:
        yield
    finally:
        cls.local_shard_size_and_offset = orig


def _place(kwargs: dict, shardings, device: str) -> tuple:
    """The cell's inputs as DTensors of fake tensors on ``device`` (under
    the caller's ``FakeTensorMode``)."""
    args = []
    for tree, sh in zip(kwargs.values(), shardings):
        if isinstance(tree, torch.Tensor):
            args.append(sh.place(torch.empty(tree.shape, dtype=tree.dtype,
                                             device=device)))
            continue
        tree = map_tree(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                              device=device), tree)
        args.append(place_(tree, sh))
    return tuple(args)


def count_cell(cell, device: str) -> dict:
    """Run ``cell``'s step once under ``FakeTensorMode`` and return its
    per-device metrics (the reference's ``_compile_metrics``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    counter = OpCounter()
    with FakeTensorMode(allow_non_fake_inputs=True), _strided_bookkeeping():
        args = _place(cell.kwargs, cell.in_shardings, device)
        counter.hold(_leaves(args))
        arg_bytes = counter.live
        with counter:
            out = cell.fn(*args)
        del args, out
    return _metrics_of(counter, arg_bytes)


def _leaves(args) -> list:
    out = []
    for a in args:
        out.extend([a] if isinstance(a, torch.Tensor) else leaves(a))
    return out


def _metrics_of(counter: OpCounter, arg_bytes: int) -> dict:
    """The flat metrics dict of a counted step."""
    coll = collective_bytes(counter.collectives)
    counts = coll.pop("_counts")
    out = {
        "flops": float(counter.flops),
        "bytes": float(counter.bytes),
        "dot_bytes": dot_bytes(counter.ops),
        "coll_total": float(sum(coll.values())),
        "mem": {"argument_size_in_bytes": int(arg_bytes),
                "temp_size_in_bytes": int(counter.peak - arg_bytes),
                "peak_memory_in_bytes": int(counter.peak)},
        "coll_counts": counts,
    }
    for k, v in coll.items():
        out[f"coll_{k}"] = float(v)
    return out


def _features(cfg, n_layers: int, mb: int):
    """[1, mb, n_layers] (hybrid: [1, mb, n_mamba, n_attn]) -- metric =
    u + mb*c + n*d.  Layer work is linear in n_layers at FIXED total tokens
    (microbatching splits the same tokens: mb is only a per-microbatch
    overhead).  The reference's counted-chunks column is dropped: XLA counts
    a while-loop body once, while the port's chunk loops are Python and are
    counted in full."""
    if cfg.family == "hybrid":
        from ..models.hybrid import plan_layers

        nm, na, _ = plan_layers(cfg.replace(n_layers=n_layers))
        return [1.0, float(mb), float(nm), float(na)]
    return [1.0, float(mb), float(n_layers)]


def _variants(cfg, mb: int) -> list[tuple[int, int]]:
    """(layers, microbatches) of the shallow variants: the reference's,
    save that the layer slope is taken at the cell's own microbatch count
    ``mb`` (DTensor picks its layouts by the shapes it meets, so a layer at
    another microbatch size may be laid out, and cost, otherwise); one
    variant at a single microbatch gives the microbatch coefficient."""
    if cfg.family == "hybrid":
        # per-layer math is attn_every-independent: fit tiny patterns
        # (attn_every=2 -> 1-2 mamba layers per variant), then extrapolate
        # to (n_mamba, n_attn)
        ls = [(2, mb), (4, mb), (3, mb)]
    else:
        ls = [(1, mb), (2, mb)]
    return ls + [(ls[0][0], 1)] if mb > 1 else ls


def _fit(A, rows, target, keys) -> dict:
    """lstsq of each key over the variants' features ``A``, evaluated at
    ``target``; never below a variant no larger than the target."""
    import numpy as np

    below = [i for i, a in enumerate(A)
             if all(x <= t for x, t in zip(a, target))]
    out = {}
    for key in keys:
        y = np.array([r.get(key, 0.0) for r in rows])
        sol, *_ = np.linalg.lstsq(np.array(A), y, rcond=None)
        out[key] = float(max([np.dot(target, sol)] + [y[i] for i in below]))
    return out


def _variant_cfg(cfg, L: int):
    vcfg = cfg.replace(n_layers=L, remat_groups=0)
    return vcfg.replace(attn_every=2) if cfg.family == "hybrid" else vcfg


def _fit_metrics(arch, shape_name, mesh, cfg, real_mb: int, device: str,
                 policy: str = "baseline", shape=None) -> dict | None:
    """Count the cell at small layer/microbatch counts, fit metric = u +
    mb*c + n_layers*d (hybrid gets a separate attention coefficient) and
    extrapolate -- exact, because layers are identical by construction.

    Memory is not linear in the microbatch count, so its temporaries are
    fitted in the layers alone, over the variants at the cell's own
    microbatch count (a train step keeps each layer's input for the
    backward, a decode step returns a new cache: both grow with the
    layers; a prefill's peak does not), and added to the full cell's
    argument bytes."""
    from ..train.train_step import TrainHParams

    shape = shape if shape is not None else SHAPES[shape_name]
    is_train = shape.kind == "train"
    mb_real = real_mb if is_train else 1
    rows, coefs, mem_rows, mem_coefs = [], [], [], []
    for L, mb in _variants(cfg, mb_real):
        vcfg = _variant_cfg(cfg, L)
        hp = TrainHParams(microbatches=mb) if is_train else None
        cell = make_cell(arch, shape_name, mesh, hp=hp, cfg_override=vcfg,
                         policy=policy, shape=shape)
        if cell.skipped:
            return None
        rows.append(count_cell(cell, device))
        coefs.append(_features(vcfg, L, mb))
        if mb == mb_real:
            mem_rows.append({"temp": float(
                rows[-1]["mem"]["temp_size_in_bytes"])})
            mem_coefs.append(_features(vcfg, L, 1))
    target = _features(cfg, cfg.n_layers, mb_real)
    fitted = _fit(coefs, rows, target, _FIT_KEYS)
    fitted["coll_counts"] = {
        kind: int(round(v)) for kind, v in _fit(
            coefs, [r["coll_counts"] for r in rows], target, _KINDS).items()}
    if shape.kind == "prefill":
        # nothing outlives a layer without a backward or a cache to return:
        # the deepest variant holds the steady peak
        fitted["temp_size_in_bytes"] = max(r["temp"] for r in mem_rows)
    else:
        fitted["temp_size_in_bytes"] = _fit(
            mem_coefs, mem_rows, _features(cfg, cfg.n_layers, 1),
            ("temp",))["temp"]
    return fitted


def _argument_bytes(cell, device: str) -> int:
    """Local bytes of the cell's arguments on this rank (from the
    shardings; nothing is run)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode(allow_non_fake_inputs=True):
        args = _place(cell.kwargs, cell.in_shardings, device)
        return sum(t._local_tensor.untyped_storage().nbytes()
                   if hasattr(t, "_local_tensor") else
                   t.untyped_storage().nbytes() for t in _leaves(args))


def run_cell(arch: str, shape_name: str, multi_pod: bool, verbose: bool = True,
             fit: bool = True, cfg_override=None, policy: str = "baseline",
             microbatches: int | None = None, device=None) -> dict:
    mesh_name = "multi" if multi_pod else "single"
    t0 = time.time()
    base = {"arch": arch, "shape": shape_name, "mesh": mesh_name}
    try:
        dtype = _device_type(device)
        base["device"] = dtype
        fake_world(512 if multi_pod else 256)
        mesh = make_production_mesh(multi_pod=multi_pod, device=dtype)
        hp = None
        if microbatches is not None:
            from ..train.train_step import TrainHParams

            hp = TrainHParams(microbatches=abs(microbatches),
                              remat=microbatches > 0)
        cell = make_cell(arch, shape_name, mesh, hp=hp, cfg_override=cfg_override,
                         policy=policy)
        if cell.skipped:
            if verbose:
                print(f"SKIP  {arch} x {shape_name} x {mesh_name}: {cell.skip_reason}")
            return {**base, "status": "skip", "reason": cell.skip_reason}

        shape = SHAPES[shape_name]
        real_mb = (abs(microbatches) if microbatches is not None else
                   default_microbatches(cell.cfg, shape, mesh, policy))
        fitted = (
            _fit_metrics(arch, shape_name, mesh, cell.cfg, real_mb, dtype,
                         policy)
            if fit else None
        )
        if fitted:
            use = fitted
            arg = _argument_bytes(cell, dtype)
            mem_d = {"argument_size_in_bytes": arg,
                     "temp_size_in_bytes": int(fitted["temp_size_in_bytes"])}
            mem_d["peak_memory_in_bytes"] = arg + mem_d["temp_size_in_bytes"]
        else:
            use = count_cell(cell, dtype)
            mem_d = use["mem"]
        specs = get_api(cell.cfg).param_specs(cell.cfg)
        n_params = count_params(specs)
        n_active = active_params(cell.cfg, specs)
        chips = mesh.size()
        per_dev = float(mem_d["argument_size_in_bytes"]
                        + mem_d["temp_size_in_bytes"])
        terms = RooflineTerms(
            arch=arch,
            shape=shape_name,
            mesh=mesh_name,
            chips=chips,
            hlo_flops=use["flops"] * chips,   # counted per device
            hlo_bytes=use["bytes"] * chips,
            hbm_bytes_est=use["dot_bytes"] * chips,
            coll_bytes_link=use["coll_total"],
            coll_by_kind={k: use.get(f"coll_{k}", 0.0) for k in _KINDS},
            model_flops=model_flops(cell.cfg, shape, n_params, n_active),
            per_device_memory=per_dev,
        )
        row = terms.row()
        row.update(
            base,
            status="ok",
            n_params=n_params,
            n_active=n_active,
            microbatches=real_mb if shape.kind == "train" else 1,
            compile_s=time.time() - t0,
            memory_analysis=mem_d,
            raw_metrics={k: use.get(k) for k in _FIT_KEYS},
            fitted=bool(fitted),
            coll_counts=use["coll_counts"],
        )
        if verbose:
            print(
                f"OK    {arch} x {shape_name} x {mesh_name}: "
                f"{row['per_device_memory']/2**30:.2f} GiB/dev, "
                f"flops={row['hlo_flops']:.3e}, "
                f"t_comp={row['t_compute']*1e3:.2f}ms "
                f"t_mem={row['t_memory']*1e3:.2f}ms "
                f"t_coll={row['t_collective']*1e3:.2f}ms "
                f"bottleneck={row['bottleneck']} "
                f"({row['compile_s']:.0f}s)", flush=True
            )
        return row
    except Exception as e:  # noqa: BLE001 -- a failed cell is a result, not a crash
        if verbose:
            print(f"FAIL  {arch} x {shape_name} x {mesh_name}: {e}")
            traceback.print_exc()
        return {**base, "status": "fail", "error": f"{type(e).__name__}: {e}",
                "compile_s": time.time() - t0}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--policy", default="baseline",
                    choices=["baseline", "dp2d", "sp", "serve"])
    ap.add_argument("--no-fit", action="store_true",
                    help="count the full-depth step once instead of fitting "
                         "shallow variants (slow for the deep configs)")
    ap.add_argument("--device", default=None,
                    help="device type the mesh counts for (default: the "
                         "card; 'cpu' on the host)")
    args = ap.parse_args(argv)
    dtype = _device_type(args.device)

    archs = list_archs() if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    os.makedirs(args.out, exist_ok=True)
    suffix = "" if args.policy == "baseline" else f"__{args.policy}"
    # mesh outermost: the fake process group is made once per world size
    for mp in meshes:
        for arch in archs:
            for shape in shapes:
                tag = f"{arch}__{shape}__{'multi' if mp else 'single'}{suffix}"
                path = os.path.join(args.out, tag + ".json")
                if os.path.exists(path):
                    print(f"CACHED {tag}")
                    continue
                row = run_cell(arch, shape, mp, policy=args.policy,
                               fit=not args.no_fit, device=dtype)
                row["policy"] = args.policy
                with open(path, "w") as f:
                    json.dump(row, f, indent=1, default=str)


if __name__ == "__main__":
    main()
