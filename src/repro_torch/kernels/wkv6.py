"""The RWKV-6 WKV recurrence, in CUDA.

Per (batch, head) and time step t::

    out_t = r_t . (S + (u * k_t) v_t^T)
    S    <- diag(exp(log_w_t)) S + k_t v_t^T

with ``r, k, v, log_w`` of shape ``(B, S, H, D)``, ``u (H, D)``, the ``D x D``
state in float32 and the output in ``r``'s dtype.  The recurrence is serial
in time and parallel over (batch, head).

Kernel note
-----------
:func:`wkv6` replaces the TPU kernel ``wkv6`` of ``src/repro/kernels/wkv6.py``
(its grid ``(B, H, chunks)`` with the state in VMEM scratch across the chunk
axis).  The work is bound by bytes: each input read once and the output
written once, 1.0 GB at rwkv6-3b's width (B 8, S 4096, H 40, D 64; bf16 r,
k, v, float32 log_w), 0.30 ms at 3.35 TB/s.  On the card it launches
``csrc/wkv6.cu``, one of two instances picked by the dtype of r, k, v
(:data:`INSTANCES`):

* ``chunk_tc_bf16`` (bfloat16; log_w in bfloat16 or float32; D 32 or 64):
  the chunked form of the recurrence on the tensor cores.  Time in chunks
  of :data:`TC_CHUNK` = 32 steps; inside a chunk the decays are products of
  ``w = exp(log_w)`` that restart at every quarter of 8 steps, so no factor
  exceeds 1; the output is ``(r o exp(ce)) S_prev + A V`` with the intra-chunk
  scores ``A`` from two tensor-core products between reference points (the
  16 x 16 block between the chunk's subchunks of 16, the 8 x 8 blocks
  between the quarters of each subchunk) and four 8 x 8 diagonal blocks
  element by element, and the state carry ``S o exp(c_last) + (k o
  exp(c_last - c))^T V`` is one more product (``mma.sync`` m16n8k16, bf16
  operands, float32 accumulators; the state stays float32 in registers).
  One block of four warps per (b, h); chunks stream through a two-stage
  ring of TMA boxes (one thread issues them, an mbarrier a stage) so that
  the next chunk loads while this one computes; 76 KB of shared memory a
  block, so three blocks share an SM and every (b, h) of the bench shape is
  in flight at once.  The result does
  not depend on the caller's ``chunk`` (it keeps only the reference's
  ``S % min(chunk, S)`` contract); a ragged last chunk is zero-filled.
* ``scalar_f32`` (float32, held to 5e-5, beyond bf16 and TF32 products):
  one block of D threads per (b, h); thread e owns column e of the state in
  registers; chunks of ``min(chunk, 64)`` steps are staged in shared memory
  and read as broadcasts.

The plain version is :func:`repro_torch.kernels.ref.wkv6_ref` (the
sequential float32 recurrence); :func:`repro_torch.kernels.ops.wkv6` picks
between the two by ``r.is_cuda``.  :func:`repro_torch.kernels.ref.
wkv6_chunked_ref` repeats ``chunk_tc_bf16``'s chunk arithmetic in float32 for
the tests.  This wrapper raises on a CPU tensor and on anything the kernel
does not take; it never runs the plain version.
"""
from __future__ import annotations

import ctypes

import torch

__all__ = ["wkv6", "launch_plan", "check_chunk", "smem_bytes",
           "tc_smem_bytes", "instance_for", "blocks_per_sm", "INSTANCES",
           "MAX_D", "TC_HEAD_DIMS", "TC_CHUNK", "MAX_STAGED_STEPS",
           "MAX_SMEM_BYTES"]

MAX_SMEM_BYTES = 232_448      # dynamic shared memory one block may opt into
MAX_D = 64                    # scalar_f32: state registers a thread holds
MAX_STAGED_STEPS = 64         # scalar_f32: time steps staged at once
TC_HEAD_DIMS = (32, 64)       # chunk_tc_bf16's instances
TC_CHUNK = 32                 # chunk_tc_bf16: steps a chunk (TC_C)
#: instance -> dtype of r, k, v
INSTANCES = {"scalar_f32": torch.float32, "chunk_tc_bf16": torch.bfloat16}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def instance_for(dtype) -> str:
    """The kernel instance that takes r, k, v of ``dtype``."""
    for name, dt in INSTANCES.items():
        if dt == dtype:
            return name
    raise ValueError(f"dtype {dtype} not taken (bfloat16 or float32)")


def check_chunk(S: int, chunk: int) -> int:
    """The reference's chunking rule: ``chunk = min(chunk, S)`` must divide
    ``S``.  Returns the chunk; raises ``ValueError`` otherwise."""
    if int(chunk) <= 0:
        raise ValueError(f"chunk must be positive, got {chunk}")
    chunk = min(int(chunk), S)
    if S and S % chunk:
        raise ValueError(f"S={S} is not a multiple of chunk={chunk}: pad "
                         f"sequence to a chunk multiple")
    return chunk


def smem_bytes(tc: int, D: int) -> int:
    """Dynamic shared memory of one ``scalar_f32`` block: ``tc`` steps of r,
    k, exp(log_w) and v, and u (the layout of ``csrc/wkv6.cu``)."""
    return 4 * (4 * tc * D + D)


def tc_smem_bytes(D: int, w_bytes: int) -> int:
    """Dynamic shared memory of one ``chunk_tc_bf16`` block (``TcLayout`` of
    ``csrc/wkv6.cu``): two ring stages of a chunk's TMA boxes, v, r and k in
    bf16 and log_w at ``w_bytes`` an element; the operand tiles r o exp(ce)
    and k o exp(c_last - c) (32 rows padded by 8, each a bf16 pair hi + lo),
    four fp16 tiles of 16 padded rows, the 32 x 40 score tile (a bf16 pair);
    the chunk's decay, u and the four quarters' summed log decay in float32;
    two mbarriers; 1024 bytes to align the swizzled boxes."""
    C, ldt = TC_CHUNK, D + 8
    stage = 3 * C * D * 2 + C * D * w_bytes
    tiles = (4 * C * ldt * 2 + 4 * 16 * ldt * 2 + 2 * C * (C + 8) * 2
             + 6 * D * 4)
    return 2 * stage + tiles + 16 + 1024


def launch_plan(r, k, v, log_w, u, chunk=64):
    """Check the inputs and size the launch; raise ``ValueError`` on anything
    the kernel does not take.  Returns a dict of the launch's integers and
    the instance's name."""
    if r.dim() != 4:
        raise ValueError(f"expected r (B, S, H, D), got {tuple(r.shape)}")
    B, S, H, D = r.shape
    for name, t in (("k", k), ("v", v), ("log_w", log_w)):
        if tuple(t.shape) != tuple(r.shape):
            raise ValueError(f"{name} {tuple(t.shape)} does not match r "
                             f"{tuple(r.shape)}")
    if tuple(u.shape) != (H, D):
        raise ValueError(f"u {tuple(u.shape)} is not (H, D) = ({H}, {D})")
    instance = instance_for(r.dtype)
    if k.dtype != r.dtype or v.dtype != r.dtype:
        raise ValueError(f"r, k, v must share one dtype, got {r.dtype}, "
                         f"{k.dtype}, {v.dtype}")
    if log_w.dtype not in _DTYPES or not u.dtype.is_floating_point:
        raise ValueError(f"log_w dtype {log_w.dtype} / u dtype {u.dtype} not "
                         f"taken (bfloat16 or float32)")
    if instance == "chunk_tc_bf16" and D not in TC_HEAD_DIMS:
        raise ValueError(f"head_dim {D} not taken by {instance} (built for "
                         f"{TC_HEAD_DIMS})")
    if D > MAX_D or D % 4 or D <= 0:
        raise ValueError(f"head_dim {D} not taken: the kernel holds at most "
                         f"{MAX_D} state registers a thread, D a multiple of 4")
    chunk = check_chunk(S, chunk)
    for name, t in (("k", k), ("v", v), ("log_w", log_w), ("u", u)):
        if t.device != r.device:
            raise ValueError(f"{name} is on {t.device}, r on {r.device}")
    tc = max(1, min(chunk, MAX_STAGED_STEPS))
    if instance == "chunk_tc_bf16":
        smem = tc_smem_bytes(D, log_w.element_size())
    else:
        smem = smem_bytes(tc, D)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"{smem} bytes of shared memory exceed the "
                         f"{MAX_SMEM_BYTES} a block may use")
    if not r.is_cuda:
        raise ValueError(
            "wkv6 kernel: the tensors are on the CPU; the plain version is "
            "repro_torch.kernels.ops.wkv6")
    return dict(B=B, S=S, H=H, D=D, tc=tc, smem=smem, dtype=_DTYPES[r.dtype],
                w_dtype=_DTYPES[log_w.dtype], instance=instance)


def _lib():
    from . import _build
    lib = _build.load("wkv6")
    fn = lib.wkv6_launch
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci,
                       ci, vp]
        fn.restype = ci
    return fn


def _aligned(t):
    """``t`` contiguous and 16-byte aligned (the base address a TMA tensor
    map takes)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def blocks_per_sm(D: int, w_dtype=torch.float32) -> int:
    """Blocks of ``chunk_tc_bf16`` at head_dim ``D`` that one SM of the
    current card holds at once (the CUDA occupancy query after the kernel's
    shared-memory opt-in)."""
    from . import _build
    fn = _build.load("wkv6").wkv6_tc_blocks_per_sm
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    n = fn(int(D), _DTYPES[w_dtype])
    if n < 0:
        raise RuntimeError(f"wkv6: occupancy query failed for D {D}")
    return n


def wkv6(r, k, v, log_w, u, *, chunk: int = 64):
    """CUDA form of :func:`~repro_torch.kernels.ref.wkv6_ref`.  Returns
    ``(B, S, H, D)`` in ``r``'s dtype.  ``launches`` on this function counts
    kernel launches, ``launches_by_instance`` the launches of each
    instance."""
    plan = launch_plan(r, k, v, log_w, u, chunk)
    r, k, v, log_w = (_aligned(t) for t in (r, k, v, log_w))
    u = u.float().contiguous()
    out = torch.empty_like(r)
    if r.numel() == 0:
        return out
    fn = _lib()
    from ._build import check_launch
    with torch.cuda.device(r.device):
        code = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), log_w.data_ptr(),
                  u.data_ptr(), out.data_ptr(), plan["B"], plan["S"],
                  plan["H"], plan["D"], plan["tc"], plan["dtype"],
                  plan["w_dtype"], plan["smem"],
                  torch.cuda.current_stream(r.device).cuda_stream)
    check_launch(code, f"wkv6 ({plan['instance']})")
    wkv6.launches += 1
    wkv6.launches_by_instance[plan["instance"]] += 1
    return out


wkv6.launches = 0
wkv6.launches_by_instance = dict.fromkeys(INSTANCES, 0)
