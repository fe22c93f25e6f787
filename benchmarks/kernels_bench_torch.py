"""Kernel benchmarks of the PyTorch / CUDA port, measured on an NVIDIA GPU.

The counterpart of ``benchmarks/kernels_bench.py``: the same three
attention-family kernels at the same shapes, with the same analytic FLOP and
byte counts, but each kernel is *launched* on the card and timed by CUDA
events after a warm-up launch, where the reference models a TPU.  Beside the
measured time each row gives the H100 bound ``max(flops / 989e12,
bytes / 3.35e12)`` (dense bf16 tensor rate, HBM3) from those counts (for
wkv6, whose formula counts every array at 2 bytes and its float32 state
operations at the bf16 tensor rate, also the bound of the bytes it really
moves and of its operations at the float32 rate: see :func:`card_bound`), and a
PyTorch yardstick where one exists: ``scaled_dot_product_attention`` for
flash attention, a page gather + SDPA composition for paged decode, none for
wkv6.  The yardsticks are timed here and used nowhere in the port.

Run from the repository root on a machine with a CUDA device::

    PYTHONPATH=src python -m benchmarks.kernels_bench_torch

Rows are the reference's CSV ``name,us_per_call,derived``; ``derived``
carries ``AI`` and ``bound`` as in the reference, then ``bound_us``,
``card_bound_us`` where it differs, ``library_us`` and the card's name and
power limit.  Without a CUDA device
every bench raises; nothing falls back to the CPU.  Inputs are drawn on the
card from a seeded generator.  The module imports torch, numpy and the port,
never jax or the reference package (``benchmarks/common.py`` imports the
reference, so this file keeps its own ``emit``).
"""
from __future__ import annotations

import subprocess
import sys

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.latency_model import OpParams, theta_prob_inv
from repro_torch.core.tiering import TPU_HOST
from repro_torch.kernels import ops, paged_kv_gather

__all__ = ["PEAK_FLOPS", "PEAK_FLOPS_F32", "HBM_BW", "FLASH_SHAPES",
           "PAGED_SHAPES", "WKV_SHAPE", "flash_counts", "paged_counts",
           "wkv6_counts", "wkv6_card_bytes", "analytic_rows", "theta_rows",
           "model_time", "card_bound", "card", "card_state", "FLASH_WARMUP",
           "flash_inputs", "paged_inputs", "wkv_inputs",
           "flash_attention_bench", "paged_decode_bench", "wkv6_bench",
           "ALL", "main"]

#: H100 SXM, dense bf16 on the tensor cores, and HBM3 (NVIDIA's data sheet)
PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
#: ... and the dense float32 rate outside the tensor cores (wkv6's state)
PEAK_FLOPS_F32 = 67e12

#: (B, Hq, Hkv, S) at D 128: benchmarks/kernels_bench.py:30
FLASH_SHAPES = ((8, 32, 8, 4096), (1, 32, 8, 32768))
#: (B, Hq, Hkv, S) at D 128, 64-token pages: benchmarks/kernels_bench.py:41
PAGED_SHAPES = ((128, 32, 8, 32768),)
#: (B, S, H, D): benchmarks/kernels_bench.py:66
WKV_SHAPE = (8, 4096, 40, 64)
D_ATTN, PAGE = 128, 64
#: timed launches after the warm-up, per bench (three at the 32k flash shape)
REPS = {"flash": 5, "flash_long": 3, "paged": 5, "wkv6": 10}
#: untimed calls of the flash kernel and of SDPA before their timed windows
FLASH_WARMUP = 2


def emit(name: str, us_per_call: float, derived) -> None:
    print(f"{name},{us_per_call:.4f},{derived}", flush=True)


# -- the reference's analytic counts (kernels_bench.py:30-33, 43-45, 68-70) --


def flash_counts(B, Hq, Hkv, S, D=D_ATTN):
    flops = 4.0 * B * Hq * S * S * D / 2        # causal: half the blocks
    bytes_ = 2 * B * S * D * (Hq + 2 * Hkv)     # q read + kv streamed
    bytes_ += 2 * B * S * Hq * D                # out write
    return flops, bytes_


def paged_counts(B, Hq, Hkv, S, D=D_ATTN, page=PAGE):
    pages = S // page
    flops = 4.0 * B * Hq * S * D
    bytes_ = 2 * B * pages * page * Hkv * D * 2   # kv pages streamed
    return flops, bytes_


def wkv6_counts(B, S, H, D):
    flops = B * S * H * (3 * D * D + 4 * D) * 1.0
    bytes_ = 2 * B * S * H * D * 5                # r,k,v,w in + out
    return flops, bytes_


def wkv6_card_bytes(B, S, H, D):
    """The bytes wkv6 moves at the bench's types, where the reference's
    formula counts every array at 2 bytes: bf16 r, k, v read and the bf16
    output written, float32 log_w read, u (float32, ``(H, D)``) read once."""
    return B * S * H * D * (3 * 2 + 4 + 2) + 4 * H * D


def model_time(flops, bytes_, peak=PEAK_FLOPS, bw=HBM_BW):
    """``(seconds, "compute" | "hbm")``: the roofline bound of the counts."""
    t_c, t_m = flops / peak, bytes_ / bw
    return max(t_c, t_m), ("compute" if t_c >= t_m else "hbm")


def card_bound(flops, bytes_, peak=PEAK_FLOPS):
    """``(ms, "bytes" | "operations")``: the least time the card could take,
    the larger of ``bytes_`` at the memory rate and ``flops`` at ``peak``,
    the rate of the operations' type.  The one bound of each kernel that
    ``chip_smoke.py`` reports."""
    t, by = model_time(flops, bytes_, peak)
    return t * 1e3, ("operations" if by == "compute" else "bytes")


def analytic_rows():
    """``[(name, flops, bytes)]`` of every kernel row, named as the
    reference names them."""
    rows = [(f"kernels/flash/B{B}S{S}", *flash_counts(B, Hq, Hkv, S))
            for B, Hq, Hkv, S in FLASH_SHAPES]
    rows += [(f"kernels/paged_decode/B{B}S{S}", *paged_counts(B, Hq, Hkv, S))
             for B, Hq, Hkv, S in PAGED_SHAPES]
    B, S, H, D = WKV_SHAPE
    rows.append((f"kernels/wkv6/B{B}S{S}", *wkv6_counts(B, S, H, D)))
    return rows


def ai_field(name, flops, bytes_):
    """The reference's ``AI=`` field: integer for flash, one decimal else."""
    ai = flops / bytes_
    return f"AI={ai:.0f}" if "/flash/" in name else f"AI={ai:.1f}"


def theta_rows(peak=PEAK_FLOPS):
    """The reference's prefetch-pipeline rows for the paged kernel
    (kernels_bench.py:47-63): the paper's Theta model at host-memory
    latency (``TPU_HOST``, 3 us) and prefetch depth 4 and 16, with ``peak``
    as the compute rate.  Model outputs, not measurements.  Returns
    ``[(name, us, eff)]``."""
    B, Hq, Hkv, S = PAGED_SHAPES[0]
    pages = S // PAGE
    flops = 4.0 * B * Hq * S * D_ATTN
    t_page = (4.0 * Hq * PAGE * D_ATTN) / peak + 2e-7
    other = 2 * (flops / B) / peak               # rest of layer approx
    plateau = pages * t_page + other
    out = []
    for P in (4, 16):
        p = OpParams(M=float(pages), T_mem=t_page, T_io_pre=other / 2,
                     T_io_post=other / 2, T_sw=0.0, P=P)
        inv = float(theta_prob_inv(np.array([TPU_HOST.latency]), p)[0])
        out.append((f"kernels/paged_decode/pipeline_eff_P{P}", inv * 1e6,
                    plateau / inv))
    return out


# -- measurement ---------------------------------------------------------------


def _require_card():
    if not torch.cuda.is_available():
        raise RuntimeError(
            "kernels_bench_torch: no CUDA device is available; the bench "
            "measures the port's kernels on an NVIDIA GPU and has no CPU "
            "fallback")
    return torch.device("cuda", torch.cuda.current_device())


def card() -> tuple[str, str]:
    """``(name, power limit)`` as ``nvidia-smi`` reports them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr.strip()}")
    line = smi.stdout.strip().splitlines()[torch.cuda.current_device()]
    name, limit = (x.strip() for x in line.rsplit(",", 1))
    return name, limit


def cuda_ms(fn, reps):
    """Mean milliseconds of ``fn()`` over ``reps`` calls by CUDA events (the
    caller has made the warm-up call)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _row(name, ms, flops, bytes_, library_ms, extra=None, library=None,
         card_counts=None):
    """Emit one measured row; ``library`` replaces the ``library_us`` text
    where no single PyTorch call computes the function.  ``card_counts`` is
    ``(bytes, peak)`` where the reference's formula miscounts what the kernel
    moves or the type of its operations: the row's ``bound_ms`` is then the
    card's bound of those, and ``model_bound_ms`` keeps the formula's."""
    bound_s, bound = model_time(flops, bytes_)
    card_bytes, peak = card_counts or (bytes_, PEAK_FLOPS)
    bound_ms, bound_by = card_bound(flops, card_bytes, peak)
    name_, limit = card()
    lib = library or f"{library_ms * 1e3:.4f}"
    own = f"card_bound_us={bound_ms * 1e3:.4f};" if card_counts else ""
    emit(name, ms * 1e3,
         f"{ai_field(name, flops, bytes_)};bound={bound};"
         f"bound_us={bound_s * 1e6:.4f};{own}library_us={lib};"
         f"card={name_};power_limit={limit}")
    return dict(name=name, ms=ms, flops=flops, bytes=card_bytes,
                bound_ms=bound_ms, bound_by=bound_by,
                model_bound_ms=bound_s * 1e3, library_ms=library_ms,
                card=name_, power_limit=limit, **(extra or {}))


def _gen(dev, seed):
    return torch.Generator(device=dev).manual_seed(seed)


def flash_inputs(B, Hq, Hkv, S, dev, seed=0, D=D_ATTN):
    """Head-major bf16 ``(q, k, v)``, standard normal, drawn on ``dev``."""
    g = _gen(dev, seed)
    return tuple(torch.randn(B, H, S, D, generator=g, device=dev,
                             dtype=torch.bfloat16) for H in (Hq, Hkv, Hkv))


def paged_inputs(B, Hq, Hkv, S, dev, seed=0, D=D_ATTN, page=PAGE):
    """``(q, k_pages, v_pages, block_tables, lengths)`` of a full page store:
    every sequence at S tokens, its pages in a seeded random order."""
    g = _gen(dev, seed)
    pages = S // page
    n = B * pages
    q = torch.randn(B, Hq, D, generator=g, device=dev, dtype=torch.bfloat16)
    kp = torch.randn(n, page, Hkv, D, generator=g, device=dev,
                     dtype=torch.bfloat16)
    vp = torch.randn(n, page, Hkv, D, generator=g, device=dev,
                     dtype=torch.bfloat16)
    bt = torch.randperm(n, generator=g, device=dev).to(torch.int32) \
        .reshape(B, pages)
    lengths = torch.full((B,), S, dtype=torch.int32, device=dev)
    return q, kp, vp, bt, lengths


def wkv_inputs(B, S, H, D, dev, seed=0):
    """``(r, k, v, log_w, u)`` scaled as the reference's test (x 0.5,
    ``-exp(0.5 N)``, x 0.3): bf16 r, k, v; float32 log_w and u."""
    g = _gen(dev, seed)
    r, k, v = (0.5 * torch.randn(B, S, H, D, generator=g, device=dev)
               for _ in range(3))
    r, k, v = (t.to(torch.bfloat16) for t in (r, k, v))
    lw = -torch.exp(0.5 * torch.randn(B, S, H, D, generator=g, device=dev))
    u = 0.3 * torch.randn(H, D, generator=g, device=dev)
    return r, k, v, lw, u


def card_state() -> dict:
    """The card's SM clock (MHz), power draw (W) and temperature (C) as
    ``nvidia-smi`` reads them now."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr.strip()}")
    line = smi.stdout.strip().splitlines()[torch.cuda.current_device()]
    clock, power, temp = (float(x) for x in line.split(","))
    return {"sm_mhz": clock, "power_w": power, "temp_c": temp}


def flash_attention_bench(seed: int = 0) -> list[dict]:
    """``ops.flash_attention`` (head-major, causal, bf16) and
    ``F.scaled_dot_product_attention(is_causal=True, enable_gqa=True)`` on
    the same inputs, at both reference shapes.  After ``FLASH_WARMUP``
    calls of each, the two are timed in turns (kernel, library, kernel,
    library; ``reps`` launches a window): the first launches of a process
    run at a lower clock, and the card's clock moves with its heat.  ``ms``
    and ``library_ms`` are the means over both windows; the row keeps each
    window and the card's clock, power and temperature after them."""
    dev = _require_card()
    rows = []
    for B, Hq, Hkv, S in FLASH_SHAPES:
        q, k, v = flash_inputs(B, Hq, Hkv, S, dev, seed)
        reps = REPS["flash_long"] if S > 4096 else REPS["flash"]

        def kernel():
            return ops.flash_attention(q, k, v, causal=True)

        def library():
            return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                  enable_gqa=True)

        for _ in range(FLASH_WARMUP):
            kernel()
            library()
        windows = {"kernel": [], "library": []}
        for _ in range(2):
            windows["kernel"].append(cuda_ms(kernel, reps))
            windows["library"].append(cuda_ms(library, reps))
        state = card_state()
        ms = sum(windows["kernel"]) / 2
        lib_ms = sum(windows["library"]) / 2
        out = kernel()
        lib = library()
        torch.cuda.synchronize()
        if not bool(torch.isfinite(out).all()):
            raise RuntimeError(f"flash_attention B{B} S{S}: non-finite output")
        diff = float((out.float() - lib.float()).abs().max())
        rows.append(_row(f"kernels/flash/B{B}S{S}", ms,
                         *flash_counts(B, Hq, Hkv, S), lib_ms,
                         dict(shape=[B, Hq, Hkv, S, D_ATTN], reps=reps,
                              windows_ms=windows, card_state=state,
                              max_abs_diff_vs_library=diff)))
        del q, k, v, out, lib
        torch.cuda.empty_cache()
    return rows


def paged_decode_bench(seed: int = 0) -> list[dict]:
    """``ops.paged_decode_attention`` over a full page store (every sequence
    at S tokens, pages in a seeded random order), and the composition of a
    page gather with ``F.scaled_dot_product_attention(enable_gqa=True)`` (no
    length mask: every sequence is full).  The 17.2 GB store is freed before
    returning.  Then the reference's Theta-model rows, with the card's peak
    in place of the TPU's."""
    dev = _require_card()
    rows = []
    for B, Hq, Hkv, S in PAGED_SHAPES:
        q, kp, vp, bt, lengths = paged_inputs(B, Hq, Hkv, S, dev, seed)

        def kernel():
            return ops.paged_decode_attention(q, kp, vp, bt, lengths)

        def composition():
            kk = kp[bt.long()].reshape(B, S, Hkv, D_ATTN).transpose(1, 2)
            vv = vp[bt.long()].reshape(B, S, Hkv, D_ATTN).transpose(1, 2)
            return F.scaled_dot_product_attention(
                q[:, :, None], kk, vv, enable_gqa=True)[:, :, 0]

        plan = paged_kv_gather.launch_plan(q, kp, vp, bt, lengths)
        out = kernel()                              # warm-up
        ms = cuda_ms(kernel, REPS["paged"])
        comp = composition()                        # warm-up
        diff = float((out.float() - comp.float()).abs().max())
        del comp
        comp_ms = cuda_ms(composition, REPS["paged"])
        torch.cuda.synchronize()
        if not bool(torch.isfinite(out).all()):
            raise RuntimeError(f"paged_decode B{B} S{S}: non-finite output")
        row = _row(f"kernels/paged_decode/B{B}S{S}", ms,
                   *paged_counts(B, Hq, Hkv, S), None,
                   dict(shape=[B, Hq, Hkv, S, D_ATTN, PAGE],
                        reps=REPS["paged"], composition_ms=comp_ms,
                        max_abs_diff_vs_composition=diff,
                        instance=plan["instance"],
                        n_splits=plan["n_splits"],
                        store_bytes=2 * kp.numel() * kp.element_size()),
                   library=f"none: no single PyTorch call computes it;"
                           f"composition_us={comp_ms * 1e3:.4f}")
        rows.append(row)
        del q, kp, vp, bt, lengths, out
        torch.cuda.empty_cache()
    for name, us, eff in theta_rows():
        emit(name, us, f"eff={eff:.3f};model=theta at TPU_HOST 3us and "
                       f"the H100 peak {PEAK_FLOPS:.3g} FLOP/s: not measured")
        rows.append(dict(name=name, model_us=us, eff=eff, measured=False))
    return rows


def wkv6_bench(seed: int = 0) -> list[dict]:
    """``ops.wkv6`` at rwkv6-3b's width: bf16 r, k, v, float32 log_w and u,
    scaled as the reference's test (x 0.5, ``-exp(0.5 N)``, x 0.3)."""
    dev = _require_card()
    B, S, H, D = WKV_SHAPE
    r, k, v, lw, u = wkv_inputs(B, S, H, D, dev, seed)
    out = ops.wkv6(r, k, v, lw, u)                  # warm-up
    ms = cuda_ms(lambda: ops.wkv6(r, k, v, lw, u), REPS["wkv6"])
    torch.cuda.synchronize()
    if not bool(torch.isfinite(out).all()):
        raise RuntimeError("wkv6: non-finite output")
    row = _row(f"kernels/wkv6/B{B}S{S}", ms, *wkv6_counts(B, S, H, D), None,
               dict(shape=[B, S, H, D], reps=REPS["wkv6"]),
               library="none: no PyTorch call computes it",
               card_counts=(wkv6_card_bytes(B, S, H, D), PEAK_FLOPS_F32))
    del r, k, v, lw, u, out
    torch.cuda.empty_cache()
    return [row]


ALL = [flash_attention_bench, paged_decode_bench, wkv6_bench]


def main() -> int:
    _require_card()
    print("name,us_per_call,derived")
    for fn in ALL:
        fn()
    return 0


if __name__ == "__main__":
    sys.exit(main())
