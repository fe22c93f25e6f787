"""Per-op token-clock update (batched over grid cells), PyTorch / CUDA.

The hot scalar update of the simulator's IO path (see
``repro_torch.core.sim.devices``) is the token-clock grant: admit a request
at ``submit`` by taking ``svc = max(submit, clock)`` and advancing the clock
by the per-request spacing.  The grid replay performs it once per scheduler
step for every cell of the latency x threads grid, over ``(n_cells, n_ssd)``
clock planes:

  * ``devmask`` one-hot selects each cell's round-robin device (all-zero
    rows for cells whose current suboperation is not an IO submission);
  * the IOPS clock is granted first, then the bandwidth clock, matching the
    scalar loops' ``svc = max(svc, tok); tok = svc + 1/R_io`` order exactly;
  * clocks of unselected devices pass through unchanged.

Kernel note
-----------
:func:`token_clock_update` replaces the TPU kernel ``token_clock_update`` of
``src/repro/kernels/token_clock.py`` (body ``_update`` / ``_grant``).  On a
CUDA tensor it launches ``csrc/token_clock.cu``; on a CPU tensor it runs the
plain version :func:`token_clock_update_ref`, which is bit-identical (same
operations, same order; the build disables FMA contraction).  The function
moves ``G * (1 + 3 S)`` doubles and ``G * S`` mask bytes in and ``G * (1 +
2 S)`` doubles out: about 13 KB at the scenarios' (128, 2) planes, a byte
bound some 1000x below the cost of launching any kernel.  So the launch is
the bound on the card, and the design keeps a call at one launch of a
kernel that costs what an empty one does: one thread a cell; instances
specialised at compile time for ``S`` = 1, 2, 4, 8 (the row in registers,
16-byte loads and stores, the bool mask row read as one word) and a generic
one up to :data:`MAX_DEVICES`; the mask read as given (bool or an integer
type, no cast launch); the three outputs views of one allocation.  The
fused scheduler step (``csrc/sched_step.cu``) calls the same ``__device__``
grant (``csrc/token_clock.cuh``) inline instead of launching this kernel.
"""
from __future__ import annotations

import ctypes

import torch

__all__ = ["token_clock_update", "token_clock_update_ref", "MAX_DEVICES",
           "INSTANCES", "instance"]

MAX_DEVICES = 64    # TC_MAX_DEVICES in csrc/token_clock.cuh (mask is a u64)


def _grant(submit, clocks, devmask, spacing):
    """One token-clock grant: ``svc = max(submit, clocks[dev])``, and the
    selected device's clock advances to ``svc + spacing``.

    ``submit`` is ``(G, 1)``, ``clocks``/``devmask`` are ``(G, n_ssd)``,
    ``spacing`` a Python float.  A spacing of 0 disables the clock (grant
    passes through); a fully-masked row (no IO this step) is not gated: its
    ``at_dev`` reads 0.0, and simulated time is non-negative, so
    ``max(submit, 0) == submit``.
    """
    if not spacing > 0.0:
        return submit, clocks
    at_dev = torch.where(devmask, clocks, 0.0).sum(dim=-1, keepdim=True)
    svc = torch.maximum(submit, at_dev)
    new_clocks = torch.where(devmask, svc + spacing, clocks)
    return svc, new_clocks


def _update(submit, devmask, tok, bw, inv_r, cost_bw):
    """IOPS clock first, then bandwidth -- the bandwidth grant sees the
    IOPS-delayed service time, like ``SSDClocks.submit`` / the compiled
    loop.  All shapes as in :func:`_grant`."""
    svc, tok = _grant(submit, tok, devmask, inv_r)
    svc, bw = _grant(svc, bw, devmask, cost_bw)
    return svc, tok, bw


def token_clock_update_ref(submit, devmask, tok_next, bw_next, inv_r,
                           cost_bw):
    """Plain PyTorch version: grant ``submit`` (``(G,)``) against the
    per-cell per-device clocks (``(G, n_ssd)``), device selected by the
    boolean one-hot ``devmask``.  ``inv_r``/``cost_bw`` are the clock
    spacings (``1/R_io`` and ``A_io/B_io``) as Python floats; a spacing of 0
    disables that clock.  Returns ``(svc, tok_next', bw_next')``; never
    modifies its inputs.
    """
    svc, tok, bw = _update(submit[:, None], devmask.bool(), tok_next,
                           bw_next, float(inv_r), float(cost_bw))
    return svc[:, 0], tok, bw


#: the kernel's instances: ``s<S>`` specialised for a width, ``generic``
INSTANCES = ("s1", "s2", "s4", "s8", "generic")
_SPECIALISED = {1: "s1", 2: "s2", 4: "s4", 8: "s8"}
#: mask dtypes the kernel reads as they are, and their bytes
_MASK_BYTES = {torch.bool: 1, torch.uint8: 1, torch.int8: 1,
               torch.int16: 2, torch.int32: 4, torch.int64: 8}
_LAUNCH = []
_F64 = torch.float64


def _launcher():
    if not _LAUNCH:
        from . import _build
        fn = _build.load("token_clock").token_clock_launch
        vp, i32, f64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        fn.argtypes = [vp, vp, vp, vp, vp, i32, i32, i32, i32, f64, f64, vp]
        fn.restype = ctypes.c_int
        _LAUNCH.append(fn)
    return _LAUNCH[0]


def _raw_stream(index: int) -> int:
    """The current CUDA stream of device ``index`` as a pointer."""
    get = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if get is not None:
        return get(index)
    return torch.cuda.current_stream(index).cuda_stream


def instance(devmask, tok_next, bw_next) -> str:
    """The instance :func:`token_clock_update` launches for these
    (contiguous) inputs: ``s<S>`` for ``S`` in 1, 2, 4, 8 with a one-byte
    mask whose rows are aligned to their ``S`` bytes and, for an even
    ``S``, 16-byte aligned clock rows; ``generic`` otherwise."""
    return _instance(tok_next.shape[1], _MASK_BYTES.get(devmask.dtype),
                     devmask.data_ptr(), tok_next.data_ptr(),
                     bw_next.data_ptr())


def _instance(S, mask_bytes, mask_ptr, tok_ptr, bw_ptr) -> str:
    name = _SPECIALISED.get(S)
    if name is None or mask_bytes != 1 or mask_ptr % S or (
            S % 2 == 0 and (tok_ptr | bw_ptr) % 16):
        return "generic"
    return name


def token_clock_update(submit, devmask, tok_next, bw_next, inv_r, cost_bw):
    """CUDA form of :func:`token_clock_update_ref` (same contract).

    A CUDA ``tok_next`` launches the kernel, one launch a call (or raises on
    inputs it does not take); a CPU ``tok_next`` runs the plain version.
    ``launches`` on this function counts kernel launches,
    ``launches_by_instance`` them by :data:`INSTANCES`.
    """
    if not tok_next.is_cuda:
        return token_clock_update_ref(submit, devmask, tok_next, bw_next,
                                      inv_r, cost_bw)
    G, S = shape = tok_next.shape
    mb = _MASK_BYTES.get(devmask.dtype)
    dev = tok_next.get_device()
    if (mb is None or not 0 < S <= MAX_DEVICES
            or submit.dtype != _F64 or tok_next.dtype != _F64
            or bw_next.dtype != _F64 or bw_next.shape != shape
            or devmask.shape != shape or submit.shape != (G,)
            or submit.get_device() != dev or devmask.get_device() != dev
            or bw_next.get_device() != dev):
        raise ValueError(
            f"token_clock_update kernel takes float64 submit (G,) and "
            f"tok_next, bw_next (G, S) with 0 < S <= {MAX_DEVICES} and a "
            f"bool or integer devmask (G, S), all on one device; got "
            + ", ".join(f"{t.dtype} {tuple(t.shape)} on {t.device}" for t in
                        (submit, devmask, tok_next, bw_next)))
    if dev != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return token_clock_update(submit, devmask, tok_next, bw_next,
                                      inv_r, cost_bw)
    if not (submit.is_contiguous() and devmask.is_contiguous()
            and tok_next.is_contiguous() and bw_next.is_contiguous()):
        submit, devmask, tok_next, bw_next = (
            t.contiguous() for t in (submit, devmask, tok_next, bw_next))
    mp, tp, bp = devmask.data_ptr(), tok_next.data_ptr(), bw_next.data_ptr()
    name = _instance(S, mb, mp, tp, bp)
    n = G * S
    # one allocation: tok' | bw' | svc (rows 16-byte aligned for an even S)
    out = tok_next.new_empty(2 * n + G)
    code = _launcher()(submit.data_ptr(), mp, tp, bp, out.data_ptr(), G, S,
                       mb, S if name != "generic" else 0, float(inv_r),
                       float(cost_bw), _raw_stream(dev))
    if code:
        from ._build import check_launch
        check_launch(code, "token_clock_update")
    token_clock_update.launches += 1
    token_clock_update.launches_by_instance[name] += 1
    return (out.as_strided((G,), (1,), 2 * n), out.as_strided(shape, (S, 1)),
            out.as_strided(shape, (S, 1), n))


token_clock_update.launches = 0
token_clock_update.launches_by_instance = dict.fromkeys(INSTANCES, 0)
