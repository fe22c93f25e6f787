"""Paged decode attention with a multi-buffered page prefetch ring, in CUDA.

One new token per sequence attends over a page store ``(P, page, Hkv, D)``
through the sequence's block table and length.  The page store is the
*slow tier* of the paper's design, the block table its in-memory index, and
``n_buffers`` its prefetch depth P: at least ``n_buf`` pages are in flight
ahead of the page being computed --

  * issue the copies of the first pages (the prefetches),
  * for page i: wait only until page i has landed, compute on it,
  * then reuse its slot for a page further on (the yield: the pages after
    i are already in flight while page i is computed).

Kernel note
-----------
:func:`paged_decode_attention` replaces the TPU kernel
``paged_decode_attention`` of ``src/repro/kernels/paged_kv_gather.py`` (its
DMA ring of ``pltpu.make_async_copy`` into VMEM).  On the card it launches
``csrc/paged_kv_gather.cu``, one of two instances picked by dtype
(:data:`INSTANCES`), on a grid of ``(n_splits, Hkv, B)`` blocks of 128
threads:

* **Split and merge.**  Split s of (b, h) walks the pages ``[s * pps,
  (s + 1) * pps)`` of b's table (flash-decoding).  :func:`split_plan` picks
  ``n_splits`` and ``pps`` on the host from ``B``, ``Hkv``, ``ppseq`` and
  the SM count alone -- never from ``lengths``, which would wait for the
  card -- aiming at :data:`BLOCKS_PER_SM` blocks an SM with no split shorter
  than :data:`MIN_SPLIT_PAGES` pages.  A block whose range starts past its
  sequence's pages exits at once.  Each live split keeps its online softmax
  (``m``, ``l``, ``acc``) in float32; a (b, h) with one live split writes
  the output directly, otherwise the splits write float32 partials to a
  workspace and the last to arrive (a per-(b, h) counter) merges them in
  split order, so a run repeats bit for bit.  One launch a call.
* ``mma_bf16`` (bfloat16): the tensor cores, ``mma.sync`` m16n8k16 with
  float32 accumulators.  The rep = Hq / Hkv query rows (at most 16,
  zero-padded to 16) are the A operand, held in registers; the K and V of
  a 64-row round come from a ``cp.async`` ring (swizzled against bank
  conflicts) by ``ldmatrix``; each of the 4 warps takes 16 keys of a round
  with its own online softmax (``exp2f``, scores scaled in float32), and P
  packed to bf16 is the A operand of ``P V``.  The ring holds the round
  being computed plus the fewest whole rounds that hold ``n_buf`` pages
  (:func:`ring_rounds`).  D 32, 64 or 128.
* ``scalar_f32`` (float32, held to 5e-5, which bf16 and TF32 products do
  not meet): the first design over the split's pages -- a ring of ``n_buf``
  page slots, one thread per query row x key row dot product, one warp per
  row of online softmax (accurate ``expf``), one thread per column of
  ``P V``.

The output is ``acc / max(l, 1e-37)`` in ``q``'s dtype.  The work is bound
by bytes: each sequence's valid K/V rows of one head are read once
(``2 * length * D`` elements per (b, h)), plus ``q`` and the output.  A
block-table entry is read as the reference's gather reads an index: a
negative id wraps once, then the id is clamped into the store, as in the
plain version.

The plain version is :func:`repro_torch.kernels.ref.paged_decode_attention_ref`;
:func:`repro_torch.kernels.ops.paged_decode_attention` picks between the two
by ``q.is_cuda``.  This wrapper raises on a CPU tensor and on anything the
kernel does not take; it never runs the plain version.
"""
from __future__ import annotations

import ctypes
import math

import torch

__all__ = ["paged_decode_attention", "launch_plan", "split_plan",
           "smem_bytes", "ring_rounds", "workspace_bytes", "instance_for",
           "INSTANCES", "TC_HEAD_DIMS", "MAX_SMEM_BYTES", "MAX_REP_TC",
           "MAX_SPLITS", "ROUND_ROWS", "BLOCKS_PER_SM", "MIN_SPLIT_PAGES",
           "H100_SMS"]

MAX_SMEM_BYTES = 232_448      # dynamic shared memory one block may opt into
#: instance -> the dtype it takes
INSTANCES = {"scalar_f32": torch.float32, "mma_bf16": torch.bfloat16}
_INSTANCE_CODE = {"scalar_f32": 0, "mma_bf16": 1}
TC_HEAD_DIMS = (32, 64, 128)  # mma_bf16's head dims (TC_ROWS, tile_off)
MAX_REP_TC = 16               # query rows of one mma tile (TC_QROWS)
ROUND_ROWS = 64               # key rows of an mma_bf16 round (TC_ROWS)
MAX_SPLITS = 256              # splits of one (b, h): the merge's weights
BLOCKS_PER_SM = 4
MIN_SPLIT_PAGES = 4
H100_SMS = 132                # the plan's SM count for a CPU tensor


def instance_for(dtype) -> str:
    """The kernel instance that takes ``dtype``."""
    for name, dt in INSTANCES.items():
        if dt == dtype:
            return name
    raise ValueError(f"dtype {dtype} not taken (bfloat16 or float32)")


def ring_rounds(n_buf: int, page: int) -> int:
    """``mma_bf16``'s ring in 64-row rounds: the round being computed plus
    the fewest whole rounds that hold ``n_buf`` pages.  The depth is thus
    rounded up to whole rounds: at 16-token pages ``n_buf`` 2, 3 and 4 give
    the same ring of 2 rounds, 8 gives 3 and 16 gives 5."""
    return 1 + -(-n_buf * page // ROUND_ROWS)


def _ceil16(n: int) -> int:
    return -(-n // 16) * 16


def smem_bytes(instance: str, rep: int, D: int, page: int, n_buf: int,
               n_splits: int = 1) -> int:
    """Dynamic shared memory of one block, the layouts of
    ``csrc/paged_kv_gather.cu``.  ``scalar_f32``: the K and V rings of
    ``n_buf`` pages (a region also at least as large as the split merge's
    ``(n_splits + 1) * rep`` weights), then float32 q rows, accumulators,
    one page of scores and three per-row scalars.  ``mma_bf16``: the larger
    of the K and V rings of :func:`ring_rounds` 64-row rounds and the
    merges' scratch, which reuses it (the four warps' m, l and weights,
    their accumulators, the block's m and l, the split weights)."""
    if instance == "scalar_f32":
        ring = max(2 * n_buf * page * D * 4, _ceil16(4 * (n_splits + 1) * rep))
        return ring + 4 * (2 * rep * D + rep * page + 3 * rep)
    if instance == "mma_bf16":
        ring = 2 * ring_rounds(n_buf, page) * ROUND_ROWS * D * 2
        merge = 4 * (3 * 4 * MAX_REP_TC + 4 * rep * D + 2 * rep
                     + (n_splits + 1) * rep)
        return max(ring, merge)
    raise ValueError(f"unknown instance {instance!r}")


def workspace_bytes(B: int, Hkv: int, rep: int, D: int,
                    n_splits: int) -> int:
    """Device memory the wrapper allocates for the split merge: float32
    partial accumulators, m and l of every (b, h, split), and one int32
    arrival counter per (b, h); none when ``n_splits`` is 1."""
    if n_splits <= 1:
        return 0
    return 4 * B * Hkv * n_splits * rep * (D + 2) + 4 * B * Hkv


def split_plan(B: int, Hkv: int, ppseq: int, page: int, instance: str,
               n_sm: int = H100_SMS, n_splits=None) -> tuple[int, int]:
    """``(n_splits, pps)``: blocks a (b, h) is split over and pages a split.
    Every page ``< ppseq`` falls in exactly one split.  ``n_splits=None``
    aims at ``BLOCKS_PER_SM * n_sm`` blocks with splits of at least
    ``MIN_SPLIT_PAGES`` pages (and, for ``mma_bf16``, whole 64-row rounds
    where a page divides 64); a forced count is kept as given (splits past
    the table hold no page)."""
    if ppseq <= 0:
        return 1, 1
    if n_splits is not None:
        n = int(n_splits)
        if not 1 <= n <= MAX_SPLITS:
            raise ValueError(f"n_splits {n_splits} outside [1, {MAX_SPLITS}]")
        return n, -(-ppseq // n)
    align = 1
    if instance == "mma_bf16" and page < ROUND_ROWS and ROUND_ROWS % page == 0:
        align = ROUND_ROWS // page
    want = -(-BLOCKS_PER_SM * n_sm // max(1, B * Hkv))
    n = max(1, min(want, -(-ppseq // max(MIN_SPLIT_PAGES, align)),
                   MAX_SPLITS))
    pps = -(-ppseq // n)
    pps = -(-pps // align) * align
    return -(-ppseq // pps), pps


def _sm_count(device) -> int:
    if device.type != "cuda":
        return H100_SMS
    return torch.cuda.get_device_properties(device).multi_processor_count


def launch_plan(q, k_pages, v_pages, block_tables, lengths, n_buffers=2, *,
                n_splits=None):
    """Check the inputs and size the launch; raise ``ValueError`` on anything
    the kernel does not take.  Returns a dict of the launch's integers and
    the instance's name.  The split is planned for the card's SM count (an
    H100's 132 for a CPU tensor).  The device is not checked here:
    :func:`paged_decode_attention` refuses CPU tensors."""
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
    instance = instance_for(q.dtype)
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
    rep = Hq // Hkv
    if instance == "mma_bf16":
        if D not in TC_HEAD_DIMS:
            raise ValueError(f"head_dim {D} not taken by mma_bf16 (built for "
                             f"{TC_HEAD_DIMS})")
        if rep > MAX_REP_TC:
            raise ValueError(f"rep = Hq / Hkv = {rep} query rows exceed the "
                             f"{MAX_REP_TC} rows of one mma tile")
    ppseq = block_tables.shape[1]
    if ppseq * page >= 2 ** 31:
        raise ValueError(f"{ppseq} pages of {page} positions exceed int32")
    if B > 65535:
        raise ValueError(f"B={B} exceeds the grid's 65535 blocks in z")
    n_buf = max(2, min(int(n_buffers), ppseq))
    n_splits, pps = split_plan(B, Hkv, ppseq, page, instance,
                               _sm_count(q.device), n_splits)
    smem = smem_bytes(instance, rep, D, page, n_buf, n_splits)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(
            f"{smem} bytes of shared memory ({instance}: ring for {n_buf} "
            f"pages of {page} x {D}, rep {rep}, {n_splits} splits) exceed "
            f"the {MAX_SMEM_BYTES} a block may use")
    ring = ring_rounds(n_buf, page) if instance == "mma_bf16" else n_buf
    return dict(B=B, n_store=n_store, Hq=Hq, Hkv=Hkv, D=D, page=page,
                ppseq=ppseq, n_buf=n_buf, ring=ring, n_splits=n_splits,
                pps=pps, smem=smem, instance=instance,
                workspace_bytes=workspace_bytes(B, Hkv, rep, D, n_splits),
                grid=(n_splits, Hkv, B))


def _lib():
    from . import _build
    fn = _build.load("paged_kv_gather").paged_decode_launch
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp] * 9 + [ci] * 11 + [ctypes.c_float, ci, vp]
        fn.restype = ci
    return fn


def _aligned(t):
    """``t`` contiguous and 16-byte aligned (the kernel's 32-bit q loads)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def paged_decode_attention(q, k_pages, v_pages, block_tables, lengths, *,
                           n_buffers: int = 2, n_splits=None):
    """CUDA form of :func:`~repro_torch.kernels.ref.paged_decode_attention_ref`
    with at least ``max(2, min(n_buffers, ppseq))`` pages in flight ahead of
    the page being computed.  Returns ``(B, Hq, D)`` in ``q``'s dtype.
    ``n_splits`` forces the split count (None: :func:`split_plan`'s choice;
    for tests and the smoke run).  ``launches`` on this function counts
    kernel launches, ``launches_by_instance`` the launches of each
    instance."""
    plan = launch_plan(q, k_pages, v_pages, block_tables, lengths, n_buffers,
                       n_splits=n_splits)
    if not q.is_cuda:
        raise ValueError(
            "paged_decode_attention kernel: the tensors are on the CPU; the "
            "plain version is repro_torch.kernels.ops.paged_decode_attention")
    q = _aligned(q)
    block_tables = block_tables.contiguous()
    lengths = lengths.contiguous()
    out = torch.empty_like(q)
    if plan["B"] == 0:
        return out
    B, Hkv, D = plan["B"], plan["Hkv"], plan["D"]
    rep, n_splits = plan["Hq"] // Hkv, plan["n_splits"]
    ws_acc = ws_ml = counters = 0
    if n_splits > 1:
        n_part = B * Hkv * n_splits * rep
        ws = torch.empty(n_part * (D + 2), dtype=torch.float32,
                         device=q.device)
        cnt = torch.zeros(B * Hkv, dtype=torch.int32, device=q.device)
        ws_acc = ws.data_ptr()
        ws_ml = ws_acc + 4 * n_part * D
        counters = cnt.data_ptr()
    fn = _lib()
    from ._build import check_launch
    with torch.cuda.device(q.device):
        code = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                  block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                  ws_acc, ws_ml, counters,
                  B, plan["n_store"], plan["Hq"], Hkv, D, plan["page"],
                  plan["ppseq"], plan["ring"], n_splits, plan["pps"],
                  _INSTANCE_CODE[plan["instance"]], 1.0 / math.sqrt(D),
                  plan["smem"],
                  torch.cuda.current_stream(q.device).cuda_stream)
    check_launch(code, f"paged_decode_attention ({plan['instance']})")
    paged_decode_attention.launches += 1
    paged_decode_attention.launches_by_instance[plan["instance"]] += 1
    return out


paged_decode_attention.launches = 0
paged_decode_attention.launches_by_instance = dict.fromkeys(INSTANCES, 0)
