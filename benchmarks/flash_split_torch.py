"""Where the time of the port's bf16 flash attention goes, measured on an
NVIDIA GPU by leaving parts of the kernel out.

The tensor-core instance of ``src/repro_torch/kernels/csrc/flash_attention.cu``
(``wgmma_bf16``) is timed beside copies of its source with one part left
out or changed, at the reference bench's two flash shapes
(``kernels_bench_torch.FLASH_SHAPES``: B 8, S 4096 and B 1, S 32768, Hq 32,
Hkv 8, D 128, causal, bf16), with ``scaled_dot_product_attention`` as the
yardstick:

* ``kernel``: the source as it is;
* ``no_qk``, ``no_pv``, ``no_softmax``: the ``Q K^T`` product, the ``P V``
  product, or the masks and online softmax left out (the loads, waits and
  the other parts stay);
* ``loads_only``: all three left out -- the TMA ring, its barriers and the
  epilogue;
* ``no_overlap``: a tile's ``Q K^T``, softmax and ``P V`` one after another
  inside a warpgroup (no ``P V`` in flight under the next softmax);
* ``two_stages``: a ring of two stages instead of three;
* ``heads_fastest``: the grid ``(B * Hq, q blocks)``, whose blocks resident
  together belong to different heads.

The copies are written under ``build/flash_split/`` (ignored by git), built
by ``nvcc`` with the library's own flags, all at once, and each loaded in
turn under the wrapper
:func:`repro_torch.kernels.flash_attention.flash_attention`; the outputs of
the variants are not checked (they compute another function), the kernel's
is held against SDPA.  Times are CUDA events over ``REPS``
launches after a warm-up (``FLASH_WARMUP`` calls of the kernel and of SDPA,
then one call of each variant), taken in turns: SDPA, every variant, the
kernel again, SDPA again; the card's clock, power and temperature follow.

Run from the repository root on a machine with a CUDA device::

    PYTHONPATH=src python -m benchmarks.flash_split_torch

It prints ptxas's notes on each variant's D 128 instance, then one JSON
object per shape, and writes them all to ``chiprun_out/flash_split.json``.
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
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as fa

from .kernels_bench_torch import FLASH_SHAPES, FLASH_WARMUP, card, \
    card_state, cuda_ms, flash_counts, flash_inputs

__all__ = ["VARIANTS", "variant_sources", "REPS", "main"]

ROOT = Path(__file__).resolve().parents[1]
#: timed launches per variant after the warm-up, by sequence length
REPS = {4096: 5, 32768: 2}

_QK = "    wgmma_ss_n128(sc, da, db, kk > 0);\n"
_PV = ("    wgmma_rs<D>(o, a, gmma_desc(v_tile + kk * 16 * Sh::SWB,\n"
       "                                TC_BK * Sh::SWB, 8 * Sh::SWB, "
       "Sh::LAYOUT));\n")
# the masks and the softmax proper, up to the update of the row sums
_SOFTMAX = ("  if (k0 + TC_BK > S || (causal && k0 + TC_BK - 1 > q_lo) ||",
            "  la = la * corr_a + sa;")
_SOFTMAX_STUB = "  corr_a = corr_b = 1.f;\n  float sa = 0.f, sb = 0.f;\n"
_LOOP = ("    // The first tile: S = Q K^T and its softmax.",
         "    // epilogue: acc / max(l, 1e-37)")
_SEQUENTIAL = """    mbar_wait(q_full, 0);
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % TC_STAGES;
      const uint32_t ph = (it / TC_STAGES) & 1;
      mbar_wait(k_full(s), ph);
      fence_regs(o);
      fence_regs(p);
      wgmma_fence();
      start_qk<D>(sc, q_rows, k_tile(s));
      wgmma_wait<0>();
      fence_regs(sc);
      if (lane == 0) mbar_arrive(k_empty(s));
      softmax_tile(sc, (kt_last - it) * TC_BK, S, causal, window, q_lo, qa,
                   qb, cq, sl2, ma, mb, la, lb, corr_a, corr_b);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= (i & 2) ? corr_b : corr_a;
#pragma unroll
      for (int i = 0; i < TC_BK / 2; i += 2)
        p[i / 2] = pack_bf16(sc[i], sc[i + 1]);
      mbar_wait(v_full(s), ph);
      fence_regs(o);
      fence_regs(p);
      wgmma_fence();
      start_pv<D>(o, p, v_tile(s));
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(p);
      if (lane == 0) mbar_arrive(v_empty(s));
    }

"""
_GRID = [("  const int bh = blockIdx.y;", "  const int bh = blockIdx.x;"),
         ("  const int q0 = (gridDim.x - 1 - blockIdx.x) * TC_BQ;",
          "  const int q0 = (gridDim.y - 1 - blockIdx.y) * TC_BQ;"),
         ("  const dim3 grid((S + TC_BQ - 1) / TC_BQ, B * Hq);",
          "  const dim3 grid(B * Hq, (S + TC_BQ - 1) / TC_BQ);")]


def _sub(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise ValueError(f"the kernel source has {src.count(old)} copies of "
                         f"{old[:60]!r}; the split needs exactly one")
    return src.replace(old, new)


def _cut(src: str, span: tuple[str, str], new: str) -> str:
    a = src.index(span[0])
    b = src.index(span[1], a)
    if src.count(span[0]) != 1:
        raise ValueError(f"{span[0][:60]!r} is not unique in the source")
    return src[:a] + new + src[b:]


def _no_qk(src):
    return _sub(src, _QK, "    (void)da;\n    (void)db;\n")


def _no_pv(src):
    return _sub(src, _PV, "    (void)a;\n")


def _no_softmax(src):
    return _cut(src, _SOFTMAX, _SOFTMAX_STUB)


def _heads_fastest(src):
    for old, new in _GRID:
        src = _sub(src, old, new)
    return src


#: name -> edit of the kernel's source
VARIANTS = {
    "kernel": lambda s: s,
    "no_qk": _no_qk,
    "no_pv": _no_pv,
    "no_softmax": _no_softmax,
    "loads_only": lambda s: _no_softmax(_no_pv(_no_qk(s))),
    "no_overlap": lambda s: _cut(s, _LOOP, _SEQUENTIAL),
    "two_stages": lambda s: _sub(s, "#define TC_STAGES 3\n",
                                 "#define TC_STAGES 2\n"),
    "heads_fastest": _heads_fastest,
}


def variant_sources(src: str | None = None) -> dict[str, str]:
    """``name -> source`` of every variant of ``flash_attention.cu``;
    raises ``ValueError`` if an edit no longer finds its place."""
    src = src if src is not None else \
        (_build.CSRC / "flash_attention.cu").read_text()
    return {name: edit(src) for name, edit in VARIANTS.items()}


def _build_variants(out: Path) -> dict[str, ctypes.CDLL]:
    procs = {}
    for name, src in variant_sources().items():
        d = out / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "flash_attention.cu").write_text(src)
        for hdr in _build.CSRC.glob("*.cuh"):
            shutil.copy(hdr, d / hdr.name)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I",
               str(d), "-o", str(d / "lib.so"), str(d / "flash_attention.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    failed, notes = {}, {}
    for name, proc in procs.items():
        text, _ = proc.communicate()
        if proc.returncode:
            failed[name] = text[-2000:]
        # ptxas's notes on the bf16 instance at D 128: registers, spills,
        # and the C75xx remarks on how it scheduled the wgmma
        notes[name] = sorted({re.sub(r"^(\[\w+\] )?ptxas info\s*:\s*", "",
                                     ln.strip())[:160]
                              for ln in _d128_lines(text)})
    if failed:
        raise RuntimeError(f"nvcc failed for the variants {failed}")
    libs = {name: ctypes.CDLL(str(out / name / "lib.so")) for name in procs}
    return libs, notes


def _d128_lines(log: str) -> list[str]:
    """The ptxas lines about ``flash_fwd_tc_kernel<128>``."""
    out, inside = [], False
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            inside = "flash_fwd_tc_kernelILi128E" in ln
        elif "flash_fwd_tc_kernelILi128E" in ln and "C75" in ln:
            out.append(ln)
        elif inside and ("Used" in ln or "spill" in ln):
            out.append(ln)
    return out


def main(seed: int = 0) -> list[dict]:
    if not torch.cuda.is_available():
        raise RuntimeError(
            "flash_split_torch: no CUDA device is available; the split "
            "measures the port's kernel on an NVIDIA GPU and has no CPU "
            "fallback")
    dev = torch.device("cuda", torch.cuda.current_device())
    name, limit = card()
    libs, notes = _build_variants(ROOT / "build" / "flash_split")
    print(json.dumps({"ptxas_d128": notes}), flush=True)
    saved = _build._LIBS.get("flash_attention")
    rows = []
    try:
        for B, Hq, Hkv, S in FLASH_SHAPES:
            q, k, v = flash_inputs(B, Hq, Hkv, S, dev, seed)
            reps = REPS[S]

            def sdpa():
                return F.scaled_dot_product_attention(
                    q, k, v, is_causal=True, enable_gqa=True)

            def kernel():
                return fa.flash_attention(q, k, v, causal=True)

            ref = sdpa()
            _build._LIBS["flash_attention"] = libs["kernel"]
            for _ in range(FLASH_WARMUP):
                kernel()
                sdpa()
            times = {"sdpa": [cuda_ms(sdpa, reps)]}
            for variant in [*VARIANTS, "kernel"]:
                _build._LIBS["flash_attention"] = libs[variant]
                out = kernel()                          # warm-up
                times.setdefault(variant, []).append(cuda_ms(kernel, reps))
                if variant == "kernel":
                    torch.cuda.synchronize()
                    diff = out.float() - ref.float()
                    row_rel = float((diff.norm(dim=-1) / ref.float().norm(
                        dim=-1).clamp_min(1e-30)).max())
            times["sdpa"].append(cuda_ms(sdpa, reps))
            state = card_state()
            flops, _ = flash_counts(B, Hq, Hkv, S)
            row = dict(shape=[B, Hq, Hkv, S, 128], reps=reps, ms=times,
                       card_state=state,
                       kernel_tflops=[flops / t / 1e9
                                      for t in times["kernel"]],
                       kernel_row_rel_vs_sdpa=row_rel, card=name,
                       power_limit=limit)
            print(json.dumps(row), flush=True)
            rows.append(row)
            del q, k, v, ref, out, diff
            torch.cuda.empty_cache()
    finally:
        if saved is None:
            _build._LIBS.pop("flash_attention", None)
        else:
            _build._LIBS["flash_attention"] = saved
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "flash_split.json").write_text(
        json.dumps({"ptxas_d128": notes, "rows": rows}, indent=1))
    return rows


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 0)
