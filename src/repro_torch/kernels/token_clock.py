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
CUDA tensor it launches ``csrc/token_clock.cu`` (one thread per cell, a loop
over the cell's ``S`` clocks); on a CPU tensor it runs the plain version
:func:`token_clock_update_ref`, which is bit-identical (same operations, same
order; the build disables FMA contraction).  The function is bound by bytes:
``G * (1 + 3 S)`` doubles and ``G * S`` int32 in, ``G * (1 + 2 S)`` doubles
out, over the card's memory rate; at grid sizes it is a launch-latency-sized
kernel, which is why the fused scheduler step (``csrc/sched_step.cu``) calls
the same ``__device__`` grant (``csrc/token_clock.cuh``) inline instead of
launching this one per step.
"""
from __future__ import annotations

import ctypes

import torch

__all__ = ["token_clock_update", "token_clock_update_ref", "MAX_DEVICES"]

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


def _lib():
    from . import _build
    lib = _build.load("token_clock")
    fn = lib.token_clock_launch
    if fn.argtypes is None:
        vp = ctypes.c_void_p
        fn.argtypes = [vp, vp, vp, vp, vp, vp, vp, ctypes.c_int,
                       ctypes.c_int, ctypes.c_double, ctypes.c_double, vp]
        fn.restype = ctypes.c_int
    return fn


def token_clock_update(submit, devmask, tok_next, bw_next, inv_r, cost_bw):
    """CUDA form of :func:`token_clock_update_ref` (same contract).

    A CUDA ``tok_next`` launches the kernel (or raises on inputs it does not
    take); a CPU ``tok_next`` runs the plain version.  ``launches`` on this
    function counts kernel launches.
    """
    if not tok_next.is_cuda:
        return token_clock_update_ref(submit, devmask, tok_next, bw_next,
                                      inv_r, cost_bw)
    G, S = tok_next.shape
    if S > MAX_DEVICES:
        raise ValueError(
            f"token_clock_update kernel takes n_ssd <= {MAX_DEVICES}, "
            f"got {S}")
    dev = tok_next.device
    for name, t, shape, dt in (("submit", submit, (G,), torch.float64),
                               ("devmask", devmask, (G, S), None),
                               ("tok_next", tok_next, (G, S), torch.float64),
                               ("bw_next", bw_next, (G, S), torch.float64)):
        if t.device != dev or tuple(t.shape) != shape or (
                dt is not None and t.dtype != dt):
            raise ValueError(
                f"{name}: expected {shape} {dt or 'bool/int'} on {dev}, got "
                f"{tuple(t.shape)} {t.dtype} on {t.device}")
    mask_i = devmask.to(torch.int32).contiguous()
    submit, tok_c, bw_c = (t.contiguous() for t in (submit, tok_next, bw_next))
    svc = torch.empty_like(submit)
    tok_out = torch.empty_like(tok_c)
    bw_out = torch.empty_like(bw_c)
    fn = _lib()
    from ._build import check_launch
    with torch.cuda.device(dev):
        code = fn(submit.data_ptr(), mask_i.data_ptr(), tok_c.data_ptr(),
                  bw_c.data_ptr(), svc.data_ptr(), tok_out.data_ptr(),
                  bw_out.data_ptr(), G, S, float(inv_r), float(cost_bw),
                  torch.cuda.current_stream(dev).cuda_stream)
    check_launch(code, "token_clock_update")
    token_clock_update.launches += 1
    return svc, tok_out, bw_out


token_clock_update.launches = 0
