"""Kernel-vs-plain check cases for the port's CUDA kernels.

The fused scheduler step:
One small grid per *flag set* (every static flag of
:func:`~repro_torch.kernels.sched_step.make_substep` switched on in at least
one set), a seeded init state, and a seeded ``(K, n_u, G)`` uniform block:
the CPU tests step these cases in both packages, and ``chip_smoke.py`` and
``test_torch_cuda.py`` run the CUDA kernel and the plain version on them on
the card.  The module imports the port only, so it loads on a machine
without jax.

The contract (:func:`states_agree`): every plane bit-equal; only the sojourn
histogram is held to "equal, or unit mass moved between adjacent bins, same
row total", because its bin index goes through ``log``.

Paged decode attention: the reference's ``PAGED_CASES`` and its length-1 /
exactly-full edge case (``tests/test_kernels.py``), the serving shape of
qwen2.5-3b and one long-context shape, with inputs drawn by numpy from a seed
(:func:`make_paged_case`).  Contract: within ``PAGED_TOL`` of the plain
version (the reference's own ``_tol``), absolute, per dtype.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.sim import replay_torch as rt
from repro_torch.kernels import sched_step as sk
from repro_torch.kernels.token_clock import token_clock_update_ref

__all__ = ["FLAG_SETS", "make_case", "step_args", "states_agree",
           "hist_equal_or_adjacent", "run_plain", "run_fused",
           "PAGED_CASES", "PAGED_EDGE", "PAGED_SERVE", "PAGED_LONG",
           "PAGED_TOL", "MODEL_TOL", "make_paged_case", "paged_tensors"]

US = 1e-6

#: name -> overrides of the dynamic scalars / static shape of one case
FLAG_SETS = {
    "plain": dict(),
    "eps+rho+jitter": dict(eps=0.05, rho=0.9, jitter=0.25),
    "rio+bio-1ssd": dict(inv_R=1 / 250e3, cost_bw_io=1024 / 400e6, n_ssd=1,
                         jitter=0.25),
    "rio+bio-2ssd": dict(inv_R=1 / 250e3, cost_bw_io=1024 / 400e6, n_ssd=2,
                         L_switch=0.3 * US, jitter=0.25),
    "bmem+lock": dict(cost_bmem=0.5 * US, T_lock=0.1 * US),
    "2cores": dict(n_cores=2, jitter=0.25, T_lock=0.05 * US),
    "open-loop+pct+deadline": dict(arr_rate=40e3, has_lat=True,
                                   deadline=300 * US, jitter=0.25),
    "io-degrade": dict(io_degrade=3.0, T_degrade=200 * US, jitter=0.25,
                       inv_R=1 / 250e3, n_ssd=2),
}


def make_case(trace, spec, seed, *, latencies=(1 * US, 5 * US),
              candidates=(3, 8), P=4, n_ops=40, warm=4, n_steps=96):
    """One self-check case as numpy data: static flags, dyn scalars, per-cell
    vectors, packed trace columns, the init state and ``n_steps`` uniform
    rows -- everything both packages (or both devices) need to step the same
    cells."""
    spec = dict(spec)
    n_cores = spec.get("n_cores", 1)
    n_ssd = spec.get("n_ssd", 1)
    has_lat = spec.get("has_lat", False)
    has_arr = "arr_rate" in spec
    deadline = spec.get("deadline", 0.0)
    flags = dict(
        has_eps=spec.get("eps", 0.0) > 0, has_rho=spec.get("rho", 1.0) < 1,
        has_jitter=spec.get("jitter", 0.0) > 0,
        has_rio=spec.get("inv_R", 0.0) > 0,
        has_bio=spec.get("cost_bw_io", 0.0) > 0,
        has_bmem=spec.get("cost_bmem", 0.0) > 0,
        has_lock=spec.get("T_lock", 0.0) > 0,
        has_degrade=spec.get("io_degrade", 1.0) != 1.0)
    n_u = 2 * flags["has_eps"] + flags["has_jitter"] + flags["has_rho"]
    dyn = (0.05 * US, spec.get("eps", 0.0), spec.get("rho", 1.0), 0.1 * US,
           80 * US, spec.get("jitter", 0.0), spec.get("inv_R", 0.0),
           spec.get("cost_bw_io", 0.0), spec.get("L_switch", 0.0),
           spec.get("cost_bmem", 0.0), spec.get("T_lock", 0.0), deadline,
           spec.get("T_degrade", 0.0), spec.get("io_degrade", 1.0))
    rng = np.random.default_rng(seed)
    L_mem_g = np.repeat(np.asarray(latencies, np.float64), len(candidates))
    nthr_g = np.tile(np.asarray(candidates, np.int32), len(latencies))
    warm_g = np.full_like(nthr_g, warm)
    G, T_max = len(L_mem_g), max(candidates)
    CT = n_cores * T_max
    arr = np.zeros(1)
    if has_arr:
        gaps = rng.exponential(1.0 / spec["arr_rate"],
                               size=4 * (CT + n_ops + warm) + 64)
        arr = np.cumsum(gaps)
        arr[:CT // 2] = 0.0          # some threads start ready, some parked
    ta = rt.lower_trace(trace, bucket=256)
    t = torch.from_numpy
    state = rt.init_state(
        ta, t(L_mem_g), t(nthr_g), t(warm_g), t(arr), t(rng.random(G)),
        t(rng.random((G, CT, 2))), T_max=T_max, P=P, n_ssd=n_ssd,
        n_cores=n_cores, rho=dyn[2], L_dram=dyn[3], has_rho=flags["has_rho"],
        has_io_clock=flags["has_rio"] or flags["has_bio"], has_arr=has_arr,
        has_lat=has_lat)
    kd = np.stack([ta.kinds.numpy().astype(np.float64), ta.durs.numpy()], 1)
    se = np.stack([ta.op_starts.numpy().astype(np.float64),
                   ta.op_ends.numpy().astype(np.float64)], 1)
    static = dict(n_u=n_u, n_ssd=n_ssd, has_arr=has_arr, has_lat=has_lat,
                  has_deadline=has_lat and deadline > 0, n_cores=n_cores,
                  **flags)
    return dict(static=static, dyn=dyn, L_mem_g=L_mem_g, nthr_g=nthr_g,
                warm_g=warm_g, arr=arr, kd=kd, se=se, n_trace=ta.n_ops,
                n_ops=n_ops, state=rt.state_to_numpy(state), G=G,
                has_lat=has_lat, u=rng.random((n_steps, n_u, G)))


def step_args(case, device="cpu"):
    """The case's tensors on ``device``: ``(state, u, fused_tail)`` where
    ``fused_tail`` are :func:`~repro_torch.kernels.sched_step.fused_steps`'s
    arguments after ``u_block``."""
    dev = torch.device(device)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    tail = (t(case["kd"]), t(case["se"]), t(case["arr"]), case["n_trace"],
            t(case["L_mem_g"]), t(case["nthr_g"]), t(case["warm_g"]),
            case["n_ops"], case["dyn"])
    return rt.state_from_numpy(case["state"], dev), t(case["u"]), tail


def run_plain(case, device="cpu", **substep_kw):
    """Step the case with the plain PyTorch body, one step at a time.  Its
    multi-device grant is the plain token clock on every device, so on the
    card the result owes nothing to either CUDA kernel."""
    substep_kw.setdefault("token_clock", token_clock_update_ref)
    state, u, (kd, se, arr, n_trace, L_mem_g, nthr_g, warm_g, n_ops,
               dyn) = step_args(case, device)
    sub = sk.make_substep(**case["static"], **substep_kw)
    for k in range(u.shape[0]):
        state = sub(state, u[k], kd, se, arr, nthr_g, n_trace, L_mem_g,
                    warm_g, n_ops, dyn)
    return state


def run_fused(case, device, block: int | None = None):
    """Step the case through :func:`fused_steps` in blocks of ``block``
    steps (default: all at once) -- the CUDA kernel on a CUDA device."""
    state, u, tail = step_args(case, device)
    sub = sk.make_substep(**case["static"])
    block = block or u.shape[0]
    for b in range(0, u.shape[0], block):
        state = sk.fused_steps(sub, state, u[b:b + block], *tail)
    return state


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view(np.int64) if a.dtype == np.float64 else a.astype(np.int64)


def hist_equal_or_adjacent(a, b) -> bool:
    """Planes equal, or unit mass moved between *adjacent* bins with every
    row total unchanged."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if a.shape != b.shape or not np.array_equal(a.sum(1), b.sum(1)):
        return False
    for row in a - b:
        nz = np.flatnonzero(row)
        i = 0
        while i < nz.size:
            # differences must pair up as (+k, -k) on neighbouring bins
            if (i + 1 >= nz.size or nz[i + 1] != nz[i] + 1
                    or row[nz[i]] + row[nz[i + 1]] != 0.0):
                return False
            i += 2
    return True


def states_agree(a, b, has_lat: bool):
    """``(ok, max_abs_err, first_bad_plane)`` for two state tuples under the
    module's contract.  ``max_abs_err`` is over the bit-equal planes (0.0
    when they agree; ``inf`` on a shape or non-finite mismatch)."""
    a = rt.state_to_numpy(a) if torch.is_tensor(a[0]) else a
    b = rt.state_to_numpy(b) if torch.is_tensor(b[0]) else b
    if len(a) != len(b):
        return False, float("inf"), -1
    ok, err, bad = True, 0.0, None
    for j, (x, y) in enumerate(zip(a, b)):
        x, y = np.asarray(x), np.asarray(y)
        if has_lat and j == len(a) - 2:
            good = hist_equal_or_adjacent(x, y)
        else:
            good = x.shape == y.shape and np.array_equal(_bits(x), _bits(y))
            if not good and x.shape == y.shape:
                with np.errstate(invalid="ignore"):
                    d = np.abs(x.astype(np.float64) - y.astype(np.float64))
                d = d[_bits(x) != _bits(y)]
                err = max(err, float(np.nan_to_num(d, nan=np.inf).max()))
            elif not good:
                err = float("inf")
        if not good:
            ok = False
            bad = j if bad is None else bad
    return ok, err, bad


# -- paged decode attention ---------------------------------------------------

#: (B, Hq, Hkv, D, page, ppseq, n_buffers, dtype): tests/test_kernels.py:50-57
PAGED_CASES = [
    (2, 4, 2, 64, 16, 8, 2, "float32"),
    (3, 8, 2, 128, 32, 4, 3, "bfloat16"),
    (1, 2, 1, 64, 8, 16, 4, "float32"),
    (4, 8, 8, 64, 16, 6, 2, "bfloat16"),
    (2, 16, 2, 128, 64, 3, 2, "float32"),
]

#: a length-1 sequence and an exactly full page table (tests/test_kernels.py:80)
PAGED_EDGE = dict(B=2, Hq=4, Hkv=2, D=64, page=8, ppseq=4, n_pages=16,
                  dtype="float32", lengths=(1, 32), tables="arange")

#: qwen2.5-3b's decode attention in ServeEngine: 8 slots, 16/2 heads,
#: head_dim 128, 16-token pages out of 1024, ragged lengths up to ~1000
PAGED_SERVE = dict(B=8, Hq=16, Hkv=2, D=128, page=16, ppseq=63,
                   n_pages=1024, dtype="bfloat16", max_len=1000)

#: the same heads at a 32k context (the repo's decode_32k sequence length)
PAGED_LONG = dict(B=8, Hq=16, Hkv=2, D=128, page=16, ppseq=2048,
                  n_pages=8 * 2048, dtype="bfloat16", max_len=32768)

PAGED_TOL = {"bfloat16": 3e-2, "float32": 5e-5}

#: bfloat16 model outputs (logits, K/V) of the port against another run of
#: the same computation (the reference, or the dense path): every layer
#: rounds q/k/v, the attention output, the residual stream and the MLP to
#: bfloat16 (8-bit significand), and two implementations round their sums in
#: different orders, so last-place differences arise and propagate.  Logits
#: and K/V of the smoke models are of order 1-4, where a bfloat16 step is
#: 0.0078-0.031; the worst difference seen on the CPU against the reference
#: is 0.055, and 0.125 is four steps at the top of that range.
MODEL_TOL = 0.125


def make_paged_case(case, seed: int = 1) -> dict:
    """Numpy inputs of one paged-attention check (float32 arrays; the
    caller casts to ``dtype``).  ``case`` is a ``PAGED_CASES`` row or one of
    the dicts above."""
    rng = np.random.default_rng(seed)
    if isinstance(case, tuple):
        B, Hq, Hkv, D, page, ppseq, n_buf, dtype = case
        P = 2 * B * ppseq
        bt = rng.permutation(P)[: B * ppseq].reshape(B, ppseq)
        lengths = [(i * 53 + 17) % (page * ppseq) + 1 for i in range(B)]
    else:
        B, Hq, Hkv, D, page, ppseq = (case[k] for k in
                                      ("B", "Hq", "Hkv", "D", "page", "ppseq"))
        P, dtype, n_buf = case["n_pages"], case["dtype"], 2
        if case.get("tables") == "arange":
            bt = np.arange(B * ppseq).reshape(B, ppseq)
            lengths = list(case["lengths"])
        else:
            # ragged lengths, each sequence's pages drawn without repeats;
            # table entries past a sequence's pages are 0, as batch_views
            # pads them
            top = case["max_len"]
            lengths = rng.integers(max(1, top // 10), top + 1, B)
            lengths[0], lengths[-1] = top, max(1, top // 10) + 1
            bt = np.zeros((B, ppseq), np.int64)
            perm = rng.permutation(P)
            used = 0
            for i, n in enumerate(lengths):
                k = -(-int(n) // page)
                bt[i, :k] = perm[used:used + k]
                used += k
    return dict(
        dtype=dtype, n_buffers=n_buf,
        q=rng.standard_normal((B, Hq, D)).astype(np.float32),
        k_pages=rng.standard_normal((P, page, Hkv, D)).astype(np.float32),
        v_pages=rng.standard_normal((P, page, Hkv, D)).astype(np.float32),
        block_tables=np.asarray(bt, np.int32),
        lengths=np.asarray(lengths, np.int32))


def paged_tensors(c: dict, device="cpu"):
    """``(q, k_pages, v_pages, block_tables, lengths)`` of a case as tensors
    on ``device``, the float arrays cast to the case's dtype."""
    dt = getattr(torch, c["dtype"])
    f = [torch.from_numpy(c[n]).to(device=device, dtype=dt)
         for n in ("q", "k_pages", "v_pages")]
    i = [torch.from_numpy(c[n]).to(device) for n in ("block_tables",
                                                       "lengths")]
    return (*f, *i)
