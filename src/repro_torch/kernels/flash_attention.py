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
VMEM scratch).  On the card it launches ``csrc/flash_attention.cu``, one of
two instances picked by dtype (:data:`INSTANCES`):

* ``wgmma_bf16`` (bfloat16): Hopper's tensor cores.  Grid ``(ceil(S / 128),
  B * Hq)``: a head's q blocks are neighbours in launch order (they share
  K and V in L2), taken last-first.  384 threads a block: a producer
  warpgroup (one thread starts the TMA loads) and two consumer warpgroups
  of 64 query rows each, registers moved from the first to the others with
  ``setmaxnreg``.  Q (128 rows) is loaded once; K and V tiles of
  ``BLOCK_K_TC`` = 128 rows stream through a ring of ``STAGES_TC`` = 3
  stages guarded by full and empty ``mbarrier`` objects (K and V each),
  swizzled by TMA, rows past S zero-filled.  Per tile a consumer computes
  ``S = Q K^T`` with ``wgmma`` (both operands from shared memory), masks
  only the tiles that cross the ragged edge, the causal diagonal or the
  window edge, runs the online softmax on the accumulator registers
  (``exp2`` of explicit FMAs, quad shuffles for the row max), and adds
  ``P V`` with a second ``wgmma`` whose A operand is P packed to bf16 in
  registers and whose B operand is V, transposed, from shared memory.  One
  tile's ``Q K^T`` and the previous tile's ``P V`` are in flight together,
  and the softmax runs under the ``P V``.  The score tile never leaves the
  registers.  The work is bound by operations (1.1e12 FLOP at B 8, S 4096,
  Hq 32, D 128, causal: 1.11 ms at the 989 TFLOP/s bf16 rate); both
  products run on the tensor cores, the loads overlap them through the ring.
* ``scalar_f32`` (float32, held to 5e-5, which neither bf16 nor TF32
  products meet): a grid of ``(B * Hq, ceil(S / 64))`` blocks of 256
  threads.  A block keeps its 64 query rows in shared memory as float32,
  pre-scaled by 1/sqrt(D), and walks the 64-row KV tiles: K tile in, scores
  (each thread a 4 x 4 micro-tile), V tile in while one warp per row runs
  the online softmax (accurate ``expf``), then ``acc = acc * corr + P V``
  with each thread's D/16 rows x 4 columns in registers, all on the float32
  FMA units.

Both skip wholly masked KV tiles; the reference masks them, which gives the
same values (``ROADMAP.md`` C9).  ``block_q`` and ``block_k`` are the
reference's VMEM tiling.  They are checked and kept in the signature, but
the CUDA tiles are the instance's whatever they say: the function does not
depend on them, only the order in which float32 sums are rounded does.

The plain version is :func:`repro_torch.kernels.ref.flash_attention_ref`
(sequence-major, S x S scores); :func:`repro_torch.kernels.ops.flash_attention`
picks between the two by ``q.is_cuda``.  This wrapper raises on a CPU tensor
and on anything the kernel does not take; it never runs the plain version.
"""
from __future__ import annotations

import ctypes
import math

import torch

__all__ = ["flash_attention", "launch_plan", "smem_bytes", "instance_for",
           "HEAD_DIMS", "INSTANCES", "MAX_SMEM_BYTES", "BLOCK_Q", "BLOCK_K",
           "BLOCK_Q_TC", "BLOCK_K_TC", "STAGES_TC"]

MAX_SMEM_BYTES = 232_448      # dynamic shared memory one block may opt into
BLOCK_Q = BLOCK_K = 64        # scalar_f32's tiles (FA_BQ, FA_BK)
BLOCK_Q_TC = BLOCK_K_TC = 128  # wgmma_bf16's tiles (TC_BQ, TC_BK)
STAGES_TC = 3                 # wgmma_bf16's K/V ring (TC_STAGES)
HEAD_DIMS = (32, 64, 128)     # the kernel's instances
#: instance -> (dtype, threads a block, query rows a block)
INSTANCES = {"scalar_f32": (torch.float32, 256, BLOCK_Q),
             "wgmma_bf16": (torch.bfloat16, 384, BLOCK_Q_TC)}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def instance_for(dtype) -> str:
    """The kernel instance that takes ``dtype``."""
    for name, (dt, _, _) in INSTANCES.items():
        if dt == dtype:
            return name
    raise ValueError(f"dtype {dtype} not taken (bfloat16 or float32)")


def smem_bytes(D: int, instance: str = "scalar_f32") -> int:
    """Dynamic shared memory of one block, the layout of
    ``csrc/flash_attention.cu``.  ``scalar_f32``: the q tile and the K/V tile
    (rows padded to D + 4 floats), the score tile (rows padded to 68) and m,
    l, corr per row.  ``wgmma_bf16``: 1024 bytes of alignment slack, the bf16
    Q tile, ``STAGES_TC`` stages of a K and a V tile, and the barriers (Q
    full; K full, V full, K empty and V empty per stage)."""
    if instance == "scalar_f32":
        return 4 * (BLOCK_Q * (D + 4) + BLOCK_K * (D + 4)
                    + BLOCK_Q * (BLOCK_K + 4) + 3 * BLOCK_Q)
    if instance == "wgmma_bf16":
        return (1024 + 2 * D * (BLOCK_Q_TC + 2 * STAGES_TC * BLOCK_K_TC)
                + 8 * (1 + 4 * STAGES_TC))
    raise ValueError(f"unknown instance {instance!r}")


def launch_plan(q, k, v, causal=True, sliding_window=None, block_q=256,
                block_k=256):
    """Check the inputs and size the launch; raise ``ValueError`` on anything
    the kernel does not take.  Returns a dict of the launch's integers and
    the instance's name.  The device is not checked here:
    :func:`flash_attention` refuses CPU tensors."""
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
    instance = instance_for(q.dtype)
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
    _, threads, rows = INSTANCES[instance]
    nq = -(-S // rows)
    # scalar_f32's grid is (B * Hq, q blocks); wgmma_bf16's (q blocks,
    # B * Hq), so that the q blocks of one head are neighbours in launch order
    grid = (nq, B * Hq) if instance == "wgmma_bf16" else (B * Hq, nq)
    if grid[1] > 65535:
        raise ValueError(f"the grid {grid} (S={S} in q blocks of {rows} "
                         f"rows, B * Hq = {B * Hq}) exceeds 65535 blocks in "
                         f"its second dimension")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    smem = smem_bytes(D, instance)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"{smem} bytes of shared memory (head_dim {D}, "
                         f"{instance}) exceed the {MAX_SMEM_BYTES} a block "
                         f"may use")
    return dict(B=B, Hq=Hq, Hkv=Hkv, S=S, D=D, causal=int(bool(causal)),
                window=window, smem=smem, dtype=_DTYPES[q.dtype],
                instance=instance, threads=threads, block_q=rows,
                grid=grid)


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
    """``t`` contiguous and 16-byte aligned (the scalar instance's vector
    loads, and the base address a TMA tensor map takes)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def flash_attention(q, k, v, *, causal: bool = True, sliding_window=None,
                    block_q: int = 256, block_k: int = 256):
    """CUDA form of :func:`~repro_torch.kernels.ref.flash_attention_ref` on
    head-major tensors.  Returns ``(B, Hq, S, D)`` in ``q``'s dtype;
    ``sliding_window`` None or 0 means no window.  ``launches`` on this
    function counts kernel launches, ``launches_by_instance`` the launches
    of each instance."""
    plan = launch_plan(q, k, v, causal, sliding_window, block_q, block_k)
    if not q.is_cuda:
        raise ValueError(
            "flash_attention kernel: the tensors are on the CPU; the plain "
            "version is repro_torch.kernels.ops.flash_attention")
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
    check_launch(code, f"flash_attention ({plan['instance']})")
    flash_attention.launches += 1
    flash_attention.launches_by_instance[plan["instance"]] += 1
    return out


flash_attention.launches = 0
flash_attention.launches_by_instance = dict.fromkeys(INSTANCES, 0)
