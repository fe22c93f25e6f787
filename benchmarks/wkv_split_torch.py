"""Where the time of the port's bf16 wkv6 kernel goes, measured on an NVIDIA
GPU by leaving parts of the kernel out.

Copies of ``src/repro_torch/kernels/csrc/wkv6.cu`` with one part left out
are timed beside the kernel as it is, at the reference bench's wkv6 shape
(``kernels_bench_torch.WKV_SHAPE``: B 8, S 4096, H 40, D 64; bf16 r, k, v,
float32 log_w and u).  The tensor-core instance (``chunk_tc_bf16``):

* ``kernel``: the source as it is;
* ``loads_only``: the ring's loads and the output store (zeros), nothing
  computed;
* ``no_intra``: the intra-chunk scores left out (the 8 x 8 diagonal blocks
  and the products between reference points; ``A V`` still runs, on a
  zero score tile);
* ``no_inter``: the inter-chunk product ``(r o exp(ce)) S`` and the
  state's carry left out;
* ``no_factors``: the chunk's factors not computed, the diagonal blocks
  with them (the later phases run on whatever the tiles hold);
* ``no_diag``: the diagonal blocks alone left out.

The direct recurrence (one block of D threads per (b, h), the first design
and the body that ``scalar_f32`` keeps), run on the same bf16 inputs by an
edit that sends bf16 r, k, v to it (``scalar_*``):

* ``scalar``: the body as it is;
* ``scalar_loads_only``: the staging loads and the output store, no step
  arithmetic (each output is the sum of the staged values of its step);
* ``scalar_arith_only``: the step arithmetic on the first chunk's staged
  values for every chunk (staging skipped after the first chunk).

The copies are written under ``build/wkv_split/`` (ignored by git), built by
``nvcc`` with the library's own flags, all at once, and each loaded in turn
under the wrapper :func:`repro_torch.kernels.wkv6.wkv6`; the variants'
outputs are not checked (they compute another function), those of
``kernel`` and ``scalar`` are held against
:func:`repro_torch.kernels.ref.wkv6_ref`.  Times are CUDA events over
``REPS`` launches after one warm-up call of each, taken in turns:
``kernel`` and ``scalar``, every other variant, then ``kernel`` and
``scalar`` again; the card's clock, power and temperature follow, and the
blocks of the instance one SM holds (the occupancy query).

Run from the repository root on a machine with a CUDA device::

    PYTHONPATH=src python -m benchmarks.wkv_split_torch

It prints ptxas's notes on the kernel each variant runs at the bench's types
and one JSON object, and writes it to ``chiprun_out/wkv_split.json``.
Without a CUDA device it raises.  The module imports torch and the port,
never jax or the reference package.
"""
from __future__ import annotations

import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import wkv6 as wk
from repro_torch.kernels.ref import wkv6_ref

from .kernels_bench_torch import WKV_SHAPE, card, card_state, cuda_ms, \
    wkv6_card_bytes, wkv_inputs

__all__ = ["VARIANTS", "TURNS", "variant_sources", "REPS", "main"]

ROOT = Path(__file__).resolve().parents[1]
#: timed launches per variant after its warm-up call
REPS = 10

# -- chunk_tc_bf16 --------------------------------------------------------------
# every phase of a chunk after the next chunk's loads are issued
_PHASES = ("    chunk_factors<D, TW>(stage, sm, warp, lane, my_t, my_s);\n",
           "  }\n}\n")
_ZEROS = """    for (int i = tid; i < TC_C * D / 2; i += TC_THREADS) {
      const int t = c * TC_C + i / (D / 2);
      if (t < S)
        *reinterpret_cast<uint32_t*>(out + base + (size_t)t * step +
                                     2 * (i % (D / 2))) = 0u;
    }
"""
_FACTORS = "    chunk_factors<D, TW>(stage, sm, warp, lane, my_t, my_s);\n"
_DIAG = ("  diag_scores<D, TW>(sm, qq, lane, my_t, my_s, rv, kv, w, us[d], "
         "us[d + 1]);\n")
_CROSS = "    cross_scores<D, TW>(sm, warp, lane);\n"
_INTER = "      inter_product<D, TW>(sm, st, y, lane);\n"
_CARRY = "  carry_state<D, TW>(sm, st, vt, lane);\n"

# -- the direct recurrence (scalar_f32's body) -----------------------------------
_DISPATCH = ("    return launch_tc_bf16(r, k, v, log_w, u, out, B, S, H, D, "
             "w_dtype, smem, s);\n")
_TO_SCALAR = """    return w_dtype == 1
        ? launch<__nv_bfloat16, __nv_bfloat16>(r, k, v, log_w, u, out, B, S,
                                               H, D, tc, smem, s)
        : launch<__nv_bfloat16, float>(r, k, v, log_w, u, out, B, S, H, D,
                                       tc, smem, s);
"""
_STAGE = ("    for (int j = 0; j < n; ++j) {\n"
          "      const size_t g = base + (size_t)(t0 + j) * step + e;\n")
_STEPS = ("    for (int j = 0; j < n; ++j) {\n      const float* rj",
          "  }\n}\n")
_STEPS_STUB = """    for (int j = 0; j < n; ++j)
      out[base + (size_t)(t0 + j) * step + e] = from_f32<T>(
          (r_s[j * D + e] + k_s[j * D + e]) + (v_s[j * D + e] + w_s[j * D + e]));
"""


def _sub(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise ValueError(f"the kernel source has {src.count(old)} copies of "
                         f"{old[:60]!r}; the split needs exactly one")
    return src.replace(old, new)


def _cut(src: str, span: tuple[str, str], new: str) -> str:
    if src.count(span[0]) != 1:
        raise ValueError(f"{span[0][:60]!r} is not unique in the source")
    a = src.index(span[0])
    b = src.index(span[1], a)
    return src[:a] + new + src[b:]


def _drop(*lines):
    def edit(src):
        for ln in lines:
            src = _sub(src, ln, "")
        return src
    return edit


def _scalar(edit=lambda s: s):
    return lambda src: edit(_sub(src, _DISPATCH, _TO_SCALAR))


#: name -> edit of the kernel's source
VARIANTS = {
    "kernel": lambda s: s,
    "loads_only": lambda s: _cut(s, _PHASES, _ZEROS),
    "no_intra": _drop(_DIAG, _CROSS),
    "no_inter": _drop(_INTER, _CARRY),
    "no_factors": _drop(_FACTORS),
    "no_diag": _drop(_DIAG),
    "scalar": _scalar(),
    "scalar_loads_only": _scalar(lambda s: _cut(s, _STEPS, _STEPS_STUB)),
    "scalar_arith_only": _scalar(
        lambda s: _sub(s, _STAGE, "    if (t0 == 0)\n" + _STAGE)),
}
#: timed first, in this order, and again last
TURNS = ("kernel", "scalar")
#: mangled-name marks of the kernels the bench's types run (D 64, bf16 r, k,
#: v, float32 log_w): the tensor-core instance and the direct recurrence
_BENCH_FUNCS = {"wkv6_tc_kernelILi64EfE": "chunk_tc_bf16",
                "wkv6_kernelI13__nv_bfloat16fE": "scalar"}


def variant_sources(src: str | None = None) -> dict[str, str]:
    """``name -> source`` of every variant of ``wkv6.cu``; raises
    ``ValueError`` if an edit no longer finds its place."""
    src = src if src is not None else (_build.CSRC / "wkv6.cu").read_text()
    return {name: edit(src) for name, edit in VARIANTS.items()}


def _bench_lines(log: str) -> dict[str, list[str]]:
    """ptxas's register and spill lines of the kernels the bench's types
    run, by kernel."""
    out, key = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            key = next((k for mark, k in _BENCH_FUNCS.items() if mark in ln),
                       None)
        elif key and ("Used" in ln or "spill" in ln):
            out.setdefault(key, []).append(
                re.sub(r"^ptxas info\s*:\s*", "", ln.strip())[:160])
    return out


def _build_variants(out: Path):
    procs = {}
    for name, src in variant_sources().items():
        d = out / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "wkv6.cu").write_text(src)
        for hdr in _build.CSRC.glob("*.cuh"):
            shutil.copy(hdr, d / hdr.name)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I",
               str(d), "-o", str(d / "lib.so"), str(d / "wkv6.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    failed, notes = {}, {}
    for name, proc in procs.items():
        text, _ = proc.communicate()
        if proc.returncode:
            failed[name] = text[-2000:]
        notes[name] = _bench_lines(text)
    if failed:
        raise RuntimeError(f"nvcc failed for the variants {failed}")
    libs = {name: ctypes.CDLL(str(out / name / "lib.so")) for name in procs}
    return libs, notes


def main(seed: int = 0) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError(
            "wkv_split_torch: no CUDA device is available; the split "
            "measures the port's kernel on an NVIDIA GPU and has no CPU "
            "fallback")
    dev = torch.device("cuda", torch.cuda.current_device())
    name, limit = card()
    libs, notes = _build_variants(ROOT / "build" / "wkv_split")
    print(json.dumps({"ptxas": notes}), flush=True)
    B, S, H, D = WKV_SHAPE
    r, k, v, lw, u = wkv_inputs(B, S, H, D, dev, seed)
    saved = _build._LIBS.get("wkv6")
    times, errs = {}, {}
    try:
        order = [*TURNS, *[n for n in VARIANTS if n not in TURNS], *TURNS]
        for variant in order:
            _build._LIBS["wkv6"] = libs[variant]
            out = wk.wkv6(r, k, v, lw, u)               # warm-up
            times.setdefault(variant, []).append(
                cuda_ms(lambda: wk.wkv6(r, k, v, lw, u), REPS))
            if variant in TURNS and variant not in errs:
                want = wkv6_ref(r, k, v, lw, u)
                torch.cuda.synchronize()
                scale = float(want.float().abs().max()) + 1e-6
                errs[variant] = float(((out.float() - want.float())
                                       / scale).abs().max())
                del want
        _build._LIBS["wkv6"] = libs["kernel"]
        blocks = wk.blocks_per_sm(D, lw.dtype)
    finally:
        if saved is None:
            _build._LIBS.pop("wkv6", None)
        else:
            _build._LIBS["wkv6"] = saved
    bytes_ = wkv6_card_bytes(B, S, H, D)
    row = dict(shape=[B, S, H, D], reps=REPS, ms=times, order=order,
               scaled_max_abs_err=errs, bytes=bytes_,
               bound_ms=bytes_ / 3.35e12 * 1e3, blocks_per_sm=blocks,
               card_state=card_state(), card=name, power_limit=limit,
               ptxas=notes)
    print(json.dumps(row), flush=True)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "wkv_split.json").write_text(json.dumps(row, indent=1))
    return row


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 0)
