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
axis).  On the card it launches ``csrc/wkv6.cu``: one block of D threads per
(b, h); thread e owns column e of the state in registers, so ``out_e`` needs
no exchange between threads.  Time streams in chunks of
``min(chunk, 64)`` steps: the chunk's r, k, v and ``exp(log_w)`` are copied
into shared memory and read there as broadcasts, one barrier per chunk; the
state never leaves the SM.  The work is bound by bytes (each input read once,
the output written once, about 1 GB at rwkv6-3b's width); what limits this
version is the serial chain of S steps in each of the B * H blocks.

The plain version is :func:`repro_torch.kernels.ref.wkv6_ref` (the
sequential float32 recurrence); :func:`repro_torch.kernels.ops.wkv6` picks
between the two by ``r.is_cuda``.  This wrapper raises on a CPU tensor and on
anything the kernel does not take; it never runs the plain version.
"""
from __future__ import annotations

import ctypes

import torch

__all__ = ["wkv6", "launch_plan", "check_chunk", "smem_bytes", "MAX_D",
           "MAX_STAGED_STEPS", "MAX_SMEM_BYTES"]

MAX_SMEM_BYTES = 232_448      # dynamic shared memory one block may opt into
MAX_D = 64                    # WKV_DMAX: state registers a thread holds
MAX_STAGED_STEPS = 64         # time steps staged in shared memory at once
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


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
    """Dynamic shared memory of one block: ``tc`` steps of r, k, exp(log_w)
    and v, and u (the layout of ``csrc/wkv6.cu``)."""
    return 4 * (4 * tc * D + D)


def launch_plan(r, k, v, log_w, u, chunk=64):
    """Check the inputs and size the launch; raise ``ValueError`` on anything
    the kernel does not take.  Returns a dict of the launch's integers."""
    if r.dim() != 4:
        raise ValueError(f"expected r (B, S, H, D), got {tuple(r.shape)}")
    B, S, H, D = r.shape
    for name, t in (("k", k), ("v", v), ("log_w", log_w)):
        if tuple(t.shape) != tuple(r.shape):
            raise ValueError(f"{name} {tuple(t.shape)} does not match r "
                             f"{tuple(r.shape)}")
    if tuple(u.shape) != (H, D):
        raise ValueError(f"u {tuple(u.shape)} is not (H, D) = ({H}, {D})")
    if r.dtype not in _DTYPES:
        raise ValueError(f"dtype {r.dtype} not taken (bfloat16 or float32)")
    if k.dtype != r.dtype or v.dtype != r.dtype:
        raise ValueError(f"r, k, v must share one dtype, got {r.dtype}, "
                         f"{k.dtype}, {v.dtype}")
    if log_w.dtype not in _DTYPES or not u.dtype.is_floating_point:
        raise ValueError(f"log_w dtype {log_w.dtype} / u dtype {u.dtype} not "
                         f"taken (bfloat16 or float32)")
    if D > MAX_D or D % 4 or D <= 0:
        raise ValueError(f"head_dim {D} not taken: the kernel holds at most "
                         f"{MAX_D} state registers a thread, D a multiple of 4")
    chunk = check_chunk(S, chunk)
    for name, t in (("k", k), ("v", v), ("log_w", log_w), ("u", u)):
        if t.device != r.device:
            raise ValueError(f"{name} is on {t.device}, r on {r.device}")
    tc = max(1, min(chunk, MAX_STAGED_STEPS))
    smem = smem_bytes(tc, D)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"{smem} bytes of shared memory exceed the "
                         f"{MAX_SMEM_BYTES} a block may use")
    if not r.is_cuda:
        raise ValueError(
            "wkv6 kernel: the tensors are on the CPU; the plain version is "
            "repro_torch.kernels.ops.wkv6")
    return dict(B=B, S=S, H=H, D=D, tc=tc, smem=smem, dtype=_DTYPES[r.dtype],
                w_dtype=_DTYPES[log_w.dtype])


def _lib():
    from . import _build
    fn = _build.load("wkv6").wkv6_launch
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci,
                       ci, vp]
        fn.restype = ci
    return fn


def wkv6(r, k, v, log_w, u, *, chunk: int = 64):
    """CUDA form of :func:`~repro_torch.kernels.ref.wkv6_ref`.  Returns
    ``(B, S, H, D)`` in ``r``'s dtype.  ``launches`` on this function counts
    kernel launches."""
    plan = launch_plan(r, k, v, log_w, u, chunk)
    r, k, v, log_w = (t.contiguous() for t in (r, k, v, log_w))
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
    check_launch(code, "wkv6")
    wkv6.launches += 1
    return out


wkv6.launches = 0
