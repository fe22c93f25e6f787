"""Blocked flash attention forward, in CUDA.

Head-major ``q (B, Hq, S, D)``, ``k`` and ``v (B, Hkv, S, D)``; query head h
reads KV head ``h // (Hq // Hkv)``; causal and sliding-window masks; the
score matrix is never formed: KV tiles stream through shared memory with an
online softmax (running max ``m``, sum ``l``, accumulator ``acc``) in float32,
and the output is ``acc / max(l, 1e-37)`` in ``q``'s dtype.

Kernel note
-----------
:func:`flash_attention` replaces the TPU kernel ``flash_attention`` of
``src/repro/kernels/flash_attention.py`` (its grid ``(B, Hq, q-blocks,
kv-blocks)`` with the KV loop as the sequential grid axis and m, l, acc in
VMEM scratch).  On the card it launches ``csrc/flash_attention.cu``: a grid
of ``(B * Hq, ceil(S / 64))`` blocks of 256 threads, the q blocks taken
last-first.  A block keeps its 64 query rows in shared memory as float32,
pre-scaled by 1/sqrt(D), and walks the 64-row KV tiles its mask leaves
visible: K tile in, scores (each thread a 4 x 4 micro-tile), V tile in while
one warp per row runs the online softmax (accurate ``expf``), then
``acc = acc * corr + P V`` with each thread's D/16 rows x 4 columns in
registers.  Wholly masked tiles are skipped; the reference masks them, which
gives the same values (``ROADMAP.md`` C9).  The work is bound by operations
(about 1.1e12 FLOP at B 8, S 4096, Hq 32, D 128, causal); this first version
does them on the float32 FMA units, not the tensor cores.

``block_q`` and ``block_k`` are the reference's VMEM tiling.  They are
checked and kept in the signature, but the CUDA tiles are 64 x 64 whatever
they say: the function does not depend on them, only the order in which
float32 sums are rounded does.

The plain version is :func:`repro_torch.kernels.ref.flash_attention_ref`
(sequence-major, S x S scores); :func:`repro_torch.kernels.ops.flash_attention`
picks between the two by ``q.is_cuda``.  This wrapper raises on a CPU tensor
and on anything the kernel does not take; it never runs the plain version.
"""
from __future__ import annotations

import ctypes
import math

import torch

__all__ = ["flash_attention", "launch_plan", "smem_bytes", "HEAD_DIMS",
           "MAX_SMEM_BYTES", "BLOCK_Q", "BLOCK_K"]

MAX_SMEM_BYTES = 232_448      # dynamic shared memory one block may opt into
BLOCK_Q = BLOCK_K = 64        # the kernel's tiles (FA_BQ, FA_BK)
HEAD_DIMS = (32, 64, 128)     # the kernel's instances
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def smem_bytes(D: int) -> int:
    """Dynamic shared memory of one block: the q tile and the K/V tile
    (rows padded to D + 4 floats), the score tile (rows padded to 68) and
    m, l, corr per row -- the layout of ``csrc/flash_attention.cu``."""
    return 4 * (BLOCK_Q * (D + 4) + BLOCK_K * (D + 4)
                + BLOCK_Q * (BLOCK_K + 4) + 3 * BLOCK_Q)


def launch_plan(q, k, v, causal=True, sliding_window=None, block_q=256,
                block_k=256):
    """Check the inputs and size the launch; raise ``ValueError`` on anything
    the kernel does not take.  Returns a dict of the launch's integers."""
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(
            f"expected head-major q (B, Hq, S, D) and k, v (B, Hkv, S, D), "
            f"got {tuple(q.shape)} and {tuple(k.shape)}")
    B, Hq, S, D = q.shape
    Bk, Hkv, Sk, Dk = k.shape
    if tuple(v.shape) != tuple(k.shape) or (Bk, Sk, Dk) != (B, S, D):
        raise ValueError(
            f"k {tuple(k.shape)} and v {tuple(v.shape)} do not match q "
            f"{tuple(q.shape)} in batch, sequence and head_dim")
    if Hkv <= 0 or Hq % Hkv:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"dtype {q.dtype} not taken (bfloat16 or float32)")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share one dtype, got {q.dtype}, "
                         f"{k.dtype}, {v.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not taken (the kernel is built for "
                         f"{HEAD_DIMS})")
    window = 0 if sliding_window is None else int(sliding_window)
    if window < 0:
        raise ValueError(f"sliding_window {sliding_window} is negative")
    if int(block_q) <= 0 or int(block_k) <= 0:
        raise ValueError(f"block sizes must be positive, got {block_q}, "
                         f"{block_k}")
    if -(-S // BLOCK_Q) > 65535:
        raise ValueError(f"S={S} needs more than 65535 q blocks")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    smem = smem_bytes(D)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"{smem} bytes of shared memory (head_dim {D}) "
                         f"exceed the {MAX_SMEM_BYTES} a block may use")
    if not q.is_cuda:
        raise ValueError(
            "flash_attention kernel: the tensors are on the CPU; the plain "
            "version is repro_torch.kernels.ops.flash_attention")
    return dict(B=B, Hq=Hq, Hkv=Hkv, S=S, D=D, causal=int(bool(causal)),
                window=window, smem=smem, dtype=_DTYPES[q.dtype])


def _lib():
    from . import _build
    fn = _build.load("flash_attention").flash_attention_launch
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, ci,
                       ctypes.c_float, ci, vp]
        fn.restype = ci
    return fn


def _aligned(t):
    """``t`` contiguous and 16-byte aligned (the kernel's vector loads)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def flash_attention(q, k, v, *, causal: bool = True, sliding_window=None,
                    block_q: int = 256, block_k: int = 256):
    """CUDA form of :func:`~repro_torch.kernels.ref.flash_attention_ref` on
    head-major tensors.  Returns ``(B, Hq, S, D)`` in ``q``'s dtype;
    ``sliding_window`` None or 0 means no window.  ``launches`` on this
    function counts kernel launches."""
    plan = launch_plan(q, k, v, causal, sliding_window, block_q, block_k)
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    fn = _lib()
    from ._build import check_launch
    with torch.cuda.device(q.device):
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  plan["B"], plan["Hq"], plan["Hkv"], plan["S"], plan["D"],
                  plan["causal"], plan["window"], plan["dtype"],
                  1.0 / math.sqrt(plan["D"]), plan["smem"],
                  torch.cuda.current_stream(q.device).cuda_stream)
    check_launch(code, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
