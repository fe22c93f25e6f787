"""Paged decode attention with a multi-buffered page prefetch ring, in CUDA.

One new token per sequence attends over a page store ``(P, page, Hkv, D)``
through the sequence's block table and length.  The page store is the
*slow tier* of the paper's design, the block table its in-memory index, and
``n_buffers`` its prefetch depth P: pages are pulled into a ring of
``n_buf`` shared-memory slots ahead of the page being computed --

  * issue the copies of pages 0 .. n_buf-1 (the prefetches),
  * for page i: wait only until page i has landed, compute on it,
  * then reuse its slot for page i + n_buf (the yield: pages i+1 .. i+n_buf-1
    are already in flight while page i is computed).

Kernel note
-----------
:func:`paged_decode_attention` replaces the TPU kernel
``paged_decode_attention`` of ``src/repro/kernels/paged_kv_gather.py`` (its
DMA ring of ``pltpu.make_async_copy`` into VMEM).  On the card it launches
``csrc/paged_kv_gather.cu``: a grid of ``(B, Hkv)`` blocks of 128 threads;
each block holds the ``rep = Hq / Hkv`` query rows of one KV head in float32,
pre-scaled by 1/sqrt(D), and fills a ring of ``n_buf`` page slots for K and V
with ``cp.async`` (16-byte copies, one commit group per page).  Per page it
takes the scores (one thread per query row x key row, a dot product over D),
an online softmax per row in float32 (positions ``>= length`` masked with
-1e30, accurate ``expf``), and the ``P V`` update (one thread per column,
the rows' sums in registers); the output is
``acc / max(l, 1e-37)`` in ``q``'s dtype.  The work is bound by bytes: each
sequence's pages of one head are read once (``2 * length * D`` elements per
(b, h), rounded up to whole pages), plus ``q`` and the output; at decode
batch sizes a block does a few hundred operations per page, far below the
card's operations-per-byte line.  This first version is simple: no tensor
cores, no TMA, and no split of a long table over several blocks, so a batch
of B sequences keeps only ``B * Hkv`` blocks busy.

The plain version is :func:`repro_torch.kernels.ref.paged_decode_attention_ref`;
:func:`repro_torch.kernels.ops.paged_decode_attention` picks between the two
by ``q.is_cuda``.  This wrapper raises on a CPU tensor and on anything the
kernel does not take; it never runs the plain version.  Page ids are not
checked here (that would wait for the card): the kernel clamps an id outside
the store into it, where the plain version raises.
"""
from __future__ import annotations

import ctypes
import math

import torch

__all__ = ["paged_decode_attention", "launch_plan", "smem_bytes",
           "MAX_SMEM_BYTES"]

MAX_SMEM_BYTES = 232_448      # dynamic shared memory one block may opt into
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def smem_bytes(rep: int, D: int, page: int, n_buf: int, elem: int) -> int:
    """Dynamic shared memory of one block: the K and V rings, then float32
    q rows, accumulators, one page of scores and three per-row scalars
    (the layout of ``csrc/paged_kv_gather.cu``)."""
    ring = 2 * n_buf * page * D * elem
    return ring + 4 * (2 * rep * D + rep * page + 3 * rep)


def launch_plan(q, k_pages, v_pages, block_tables, lengths, n_buffers=2):
    """Check the inputs and size the launch; raise ``ValueError`` on anything
    the kernel does not take.  Returns a dict of the launch's integers."""
    if q.dim() != 3 or k_pages.dim() != 4:
        raise ValueError(
            f"expected q (B, Hq, D) and pages (P, page, Hkv, D), got "
            f"{tuple(q.shape)} and {tuple(k_pages.shape)}")
    B, Hq, D = q.shape
    n_store, page, Hkv, Dk = k_pages.shape
    if Dk != D or tuple(v_pages.shape) != tuple(k_pages.shape):
        raise ValueError(
            f"k/v pages {tuple(k_pages.shape)} / {tuple(v_pages.shape)} do "
            f"not match q's head_dim {D}")
    if n_store <= 0:
        raise ValueError("the page store holds no pages")
    if Hkv <= 0 or Hq % Hkv:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"dtype {q.dtype} not taken (bfloat16 or float32)")
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise ValueError(
            f"q, k_pages, v_pages must share one dtype, got {q.dtype}, "
            f"{k_pages.dtype}, {v_pages.dtype}")
    if block_tables.dim() != 2 or block_tables.shape[0] != B \
            or tuple(lengths.shape) != (B,):
        raise ValueError(
            f"block_tables must be (B={B}, ppseq) and lengths ({B},), got "
            f"{tuple(block_tables.shape)} and {tuple(lengths.shape)}")
    if block_tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError("block_tables and lengths must be int32")
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages),
                    ("block_tables", block_tables), ("lengths", lengths)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if not (k_pages.is_contiguous() and v_pages.is_contiguous()):
        raise ValueError("the page store must be contiguous (a per-layer "
                         "view of a contiguous store is)")
    elem = q.element_size()
    if (D * elem) % 16:
        raise ValueError(
            f"a page row of {D * elem} bytes is not a multiple of the 16-byte "
            f"copies the ring is filled with")
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError("the page store is not 16-byte aligned")
    ppseq = block_tables.shape[1]
    n_buf = max(2, min(int(n_buffers), ppseq))
    rep = Hq // Hkv
    smem = smem_bytes(rep, D, page, n_buf, elem)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(
            f"{smem} bytes of shared memory (ring of {n_buf} pages of "
            f"{page} x {D}, rep {rep}) exceed the {MAX_SMEM_BYTES} a block "
            f"may use")
    if not q.is_cuda:
        raise ValueError(
            "paged_decode_attention kernel: the tensors are on the CPU; the "
            "plain version is repro_torch.kernels.ops.paged_decode_attention")
    return dict(B=B, n_store=n_store, Hq=Hq, Hkv=Hkv, D=D, page=page,
                ppseq=ppseq, n_buf=n_buf, smem=smem, dtype=_DTYPES[q.dtype])


def _lib():
    from . import _build
    fn = _build.load("paged_kv_gather").paged_decode_launch
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci,
                       ci, ci, ctypes.c_float, ci, vp]
        fn.restype = ci
    return fn


def paged_decode_attention(q, k_pages, v_pages, block_tables, lengths, *,
                           n_buffers: int = 2):
    """CUDA form of :func:`~repro_torch.kernels.ref.paged_decode_attention_ref`
    with a prefetch ring of ``max(2, min(n_buffers, ppseq))`` pages.  Returns
    ``(B, Hq, D)`` in ``q``'s dtype.  ``launches`` on this function counts
    kernel launches."""
    plan = launch_plan(q, k_pages, v_pages, block_tables, lengths, n_buffers)
    q = q.contiguous()
    block_tables = block_tables.contiguous()
    lengths = lengths.contiguous()
    out = torch.empty_like(q)
    if plan["B"] == 0:
        return out
    fn = _lib()
    from ._build import check_launch
    with torch.cuda.device(q.device):
        code = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                  block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                  plan["B"], plan["n_store"], plan["Hq"], plan["Hkv"],
                  plan["D"], plan["page"], plan["ppseq"], plan["n_buf"],
                  plan["dtype"],
                  1.0 / math.sqrt(plan["D"]), plan["smem"],
                  torch.cuda.current_stream(q.device).cuda_stream)
    check_launch(code, "paged_decode_attention")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
