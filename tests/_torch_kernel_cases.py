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
(:func:`make_paged_case`); ``PAGED_SPLIT_CASES``, which force split counts
and edge lengths on the kernel; and block tables holding page ids outside the
store (:func:`with_bad_page_ids`).  Contract: within ``PAGED_TOL`` of the
plain version (the reference's own ``_tol``), absolute, per dtype, and on
the card also within ``PAGED_ROW_TOL`` of each row's norm.

Flash attention and wkv6: the reference's ``FLASH_CASES`` and ``WKV_CASES``
with inputs drawn by numpy from a seed (:func:`make_flash_case`,
:func:`make_wkv_case`), and the full-width shapes of the reference's kernel
bench (``benchmarks/kernels_bench.py``): ``FLASH_BENCH``, ``WKV_BENCH``,
``PAGED_BENCH``.  Contract: within :func:`tol` of the plain version,
absolute; for wkv6 after dividing both sides by ``max|plain| + 1e-6``
(:func:`wkv_err`), as ``tests/test_kernels.py`` holds it.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.sim import replay_torch as rt
from repro_torch.kernels import sched_step as sk
from repro_torch.kernels.token_clock import token_clock_update_ref

__all__ = ["FLAG_SETS", "make_case", "step_args", "states_agree",
           "hist_equal_or_adjacent", "run_plain", "run_fused", "GROUP_T",
           "make_group_case", "run_group_plain", "run_group_fused",
           "PAGED_CASES", "PAGED_EDGE", "PAGED_SERVE", "PAGED_LONG",
           "PAGED_TOL", "PAGED_ROW_TOL", "MODEL_TOL", "make_paged_case",
           "paged_tensors", "PAGED_SPLIT_CASES", "with_bad_page_ids",
           "tol", "FLASH_CASES", "FLASH_LONG", "FLASH_BENCH", "FLASH_TC_CASES",
           "FLASH_ROW_TOL", "row_rel_err", "make_flash_case",
           "flash_tensors", "WKV_CASES", "WKV_BENCH", "make_wkv_case",
           "wkv_tensors", "wkv_err", "PAGED_BENCH", "WKV_TC_CASES",
           "WKV_ROW_TOL", "WKV_DECAYS", "wkv_decay"]

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
              candidates=(3, 8), P=4, n_ops=40, warm=4, n_steps=96,
              arr=None):
    """One self-check case as numpy data: static flags, dyn scalars, per-cell
    vectors, packed trace columns, the init state and ``n_steps`` uniform
    rows -- everything both packages (or both devices) need to step the same
    cells.  ``arr`` replaces the drawn arrival vector of an open-loop case
    (it must cover the case's threads)."""
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
    if not has_arr:
        arr = np.zeros(1)
    elif arr is None:
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


#: Thread slots per core of the cohorts of :func:`make_group_case`: one
#: cohort for each of the kernel bodies NS = 1, 2, 4 (8 with two cores).
GROUP_T = (5, 40, 70)


def make_group_case(trace, spec, seed, *, t_max=GROUP_T, n_steps=192,
                    **kw):
    """Cohorts of one grid, one :func:`make_case` each: thread slots
    ``t_max`` (two thread counts a cohort, the widest ``t_max``), their own
    init states and uniforms, and everything else -- flags, scalars, trace
    tables, the arrival vector -- shared, as :func:`plan_grid` shares it.
    Returns ``{"cohorts": [case, ...]}`` plus the shared entries of the
    first case."""
    cohorts = []
    arr = None
    for i, T in enumerate(sorted(t_max, reverse=True)):
        c = make_case(trace, spec, seed + i, candidates=(max(1, T - 2), T),
                      n_steps=n_steps, arr=arr, **kw)
        arr = c["arr"]
        cohorts.append(c)
    cohorts.reverse()                       # narrowest first, like plan_grid
    return dict(cohorts[0], cohorts=cohorts)


def run_group_plain(gcase, device, steps):
    """Each cohort stepped alone by the plain version, ``steps[c]`` steps."""
    return [run_plain(dict(c, u=c["u"][:n]), device)
            for c, n in zip(gcase["cohorts"], steps)]


def run_group_fused(gcase, device, steps, block=64, profile=False):
    """The cohorts through :func:`fused_steps_group`, ``block`` steps a
    launch; cohort ``c`` leaves the group after ``steps[c]`` steps (whole
    blocks), as a cohort leaves the chunk loop at its step bound.  Returns
    the states and, with ``profile``, each launch's profiling buffer."""
    dev = torch.device(device)
    _, _, (kd, se, arr, n_trace, _, _, _, n_ops, dyn) = step_args(
        gcase, dev)
    cohorts = [step_args(c, dev) for c in gcase["cohorts"]]
    states = [s for s, _, _ in cohorts]
    sub = sk.make_substep(**gcase["static"])
    profs = []
    for b in range(0, max(steps), block):
        live = [i for i, n in enumerate(steps) if n > b]
        u = torch.cat([cohorts[i][1][b:b + block] for i in live], dim=2)
        # (state, L_mem_g, nthr_g, warm_g) of each live cohort
        parts = [(states[i], *cohorts[i][2][4:7]) for i in live]
        prof = None
        if profile:
            prof = torch.zeros(sum(states[i][2].shape[0] for i in live),
                               len(sk.PROF_COLUMNS), dtype=torch.int64,
                               device=dev)
            profs.append(prof)
        new = sk.fused_steps_group(sub, parts, u.contiguous(), kd, se, arr,
                                   n_trace, n_ops, dyn, prof=prof)
        for i, s in zip(live, new):
            states[i] = s
    return (states, profs) if profile else states


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

#: paged outputs against the plain version: the largest error of one
#: (b, query head) row relative to the row, ``||got - want|| / ||want||``
#: over its D values (:func:`row_rel_err`), beside ``PAGED_TOL``.  The
#: bfloat16 instance rounds P to bfloat16 for ``P V`` (at most 2^-8 of each
#: weight) and both sides round the output to bfloat16 (at most 2^-8 of a
#: value), so a correct row is off by well under 2^-7 = 0.0078.  The
#: absolute 3e-2 is about the size of a typical output over many keys
#: (|out| ~ sqrt(e/n) for n keys: 0.009 at 32768), so alone it would pass an
#: output at half its value or a split left out of the merge.
PAGED_ROW_TOL = 1e-2

#: name -> a case with fixed lengths (tables drawn from the seed, padded with
#: page 0 past each sequence's pages, as ``batch_views`` pads them) and the
#: split count forced on the kernel (None: the plan's choice).  Between them:
#: 1, 2 and an odd 3 splits, more splits than pages, lengths 0 and 1, lengths
#: ending mid-page and mid-round, pages of 8 to 64 tokens, D 32 / 64 / 128,
#: and rep 12 (starcoder2-3b: 24 / 2 heads) and 16 (llama3-405b: 128 / 8).
PAGED_SPLIT_CASES = {
    "split1": dict(B=3, Hq=8, Hkv=2, D=128, page=16, ppseq=12, n_pages=48,
                   lengths=(192, 100, 7), n_splits=1),
    "split2": dict(B=3, Hq=8, Hkv=2, D=128, page=16, ppseq=12, n_pages=48,
                   lengths=(192, 100, 7), n_splits=2),
    "split3-odd": dict(B=3, Hq=8, Hkv=2, D=128, page=16, ppseq=12,
                       n_pages=48, lengths=(192, 100, 7), n_splits=3),
    "splits-past-pages": dict(B=2, Hq=4, Hkv=1, D=64, page=32, ppseq=4,
                              n_pages=16, lengths=(128, 33), n_splits=7),
    "len0-len1": dict(B=4, Hq=4, Hkv=2, D=64, page=8, ppseq=10, n_pages=48,
                      lengths=(0, 1, 37, 80), n_splits=3),
    "len0-alone": dict(B=2, Hq=4, Hkv=2, D=64, page=8, ppseq=10, n_pages=24,
                       lengths=(0, 0), n_splits=None),
    "rep12-starcoder2": dict(B=2, Hq=24, Hkv=2, D=128, page=16, ppseq=40,
                             n_pages=96, lengths=(611, 45), n_splits=None),
    "rep16-llama3-405b": dict(B=2, Hq=128, Hkv=8, D=128, page=64, ppseq=6,
                              n_pages=16, lengths=(383, 64), n_splits=2),
    "d32-smoke": dict(B=2, Hq=4, Hkv=2, D=32, page=8, ppseq=16, n_pages=40,
                      lengths=(128, 59), n_splits=None),
}

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
        P, n_buf = case["n_pages"], case.get("n_buffers", 2)
        dtype = case.get("dtype", "bfloat16")
        if case.get("tables") == "arange":
            bt = np.arange(B * ppseq).reshape(B, ppseq)
            lengths = list(case["lengths"])
        elif "lengths" in case:
            lengths = list(case["lengths"])
            bt = np.zeros((B, ppseq), np.int64)
            perm = rng.permutation(P)
            used = 0
            for i, n in enumerate(lengths):
                k = min(-(-int(n) // page), ppseq)
                bt[i, :k] = perm[used:used + k]
                used += k
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


def with_bad_page_ids(c: dict) -> dict:
    """``c`` with page ids outside its store of P pages in every table row:
    ``P + 2``, ``-1`` and ``-(P + 3)`` in turn at the first, middle and last
    of the sequence's own pages and at every entry past them.  Both plain
    versions read an id as the reference's gather reads an index (a
    negative id wraps once, then the id is clamped): P - 1, P - 1 and 0."""
    bt = c["block_tables"].copy()
    P, page = c["k_pages"].shape[:2]
    bad = (P + 2, -1, -(P + 3))
    for i, n in enumerate(c["lengths"]):
        k = min(-(-int(n) // page), bt.shape[1])
        cols = sorted({0, k // 2, k - 1}) if k else []
        for j, col in enumerate([*cols, *range(k, bt.shape[1])]):
            bt[i, col] = bad[j % 3]
    return {**c, "block_tables": bt}


def paged_tensors(c: dict, device="cpu", dtype=None):
    """``(q, k_pages, v_pages, block_tables, lengths)`` of a case as tensors
    on ``device``, the float arrays cast to ``dtype`` (default: the
    case's)."""
    dt = getattr(torch, dtype or c["dtype"])
    f = [torch.from_numpy(c[n]).to(device=device, dtype=dt)
         for n in ("q", "k_pages", "v_pages")]
    i = [torch.from_numpy(c[n]).to(device) for n in ("block_tables",
                                                       "lengths")]
    return (*f, *i)


# -- flash attention and wkv6 -------------------------------------------------


def tol(dtype: str) -> float:
    """The reference's ``_tol`` (tests/test_kernels.py:18): absolute, 3e-2
    in bfloat16 (an 8-bit significand on outputs of order 1) and 5e-5 in
    float32 (sums of up to a few thousand float32 products taken in another
    order)."""
    return 3e-2 if dtype == "bfloat16" else 5e-5


#: (B, S, Hq, Hkv, D, causal, window, dtype, block_q, block_k):
#: tests/test_kernels.py:22-29
FLASH_CASES = [
    (2, 256, 4, 2, 64, True, None, "float32", 128, 128),
    (1, 512, 2, 2, 128, True, None, "bfloat16", 128, 256),
    (2, 384, 4, 1, 64, False, None, "float32", 128, 128),
    (1, 512, 4, 2, 64, True, 128, "float32", 128, 128),
    (1, 256, 8, 8, 128, True, None, "bfloat16", 64, 64),
    (3, 128, 2, 1, 32, True, None, "float32", 64, 64),
]

#: llava-next-mistral-7b's language-model heads at a 4k context, batch 1:
#: the widest shape at which the plain version's S x S scores (2.1 GB in
#: float32) still fit beside the kernel on the card
FLASH_LONG = (1, 4096, 32, 8, 128, True, None, "bfloat16", 256, 256)

#: bfloat16 cases for the tensor-core instance (``wgmma_bf16``): between
#: them every head_dim (32: 64-byte swizzle; 64: one 128-byte box; 128: two
#: boxes), no mask, causal, windows 128 and 300 with their edge inside
#: S 1000, GQA groups of 1, 4 and 8, ragged S of 1, 63, 200 and 1000 (below
#: one 128-row tile, a partial last tile, several tiles), and B > 1; the last
#: has 512 blocks of 128 rows, more than the card's 132 SMs take at once.
#: The
#: reference's block sizes (its tiling, which the CUDA kernel ignores)
#: divide S or exceed it: its Pallas kernel, run in interpret mode, reads
#: the rows past S of a partial KV block as NaN, and 0 x NaN reaches its P V
FLASH_TC_CASES = [
    (2, 1, 4, 4, 128, True, None, "bfloat16", 256, 256),
    (2, 63, 4, 4, 32, True, None, "bfloat16", 256, 256),
    (1, 63, 8, 2, 64, False, None, "bfloat16", 256, 256),
    (2, 200, 8, 1, 32, True, None, "bfloat16", 256, 256),
    (1, 200, 4, 1, 128, False, None, "bfloat16", 256, 256),
    (1, 1000, 8, 2, 128, True, 128, "bfloat16", 200, 200),
    (1, 1000, 4, 4, 64, True, 300, "bfloat16", 200, 200),
    (2, 1000, 8, 1, 32, False, None, "bfloat16", 200, 200),
    (1, 1000, 8, 8, 128, True, None, "bfloat16", 200, 200),
    (4, 1000, 16, 4, 64, True, 300, "bfloat16", 200, 200),
]

#: bfloat16 flash outputs against a float32-summed version of the same
#: function: the largest error of one query row relative to the row,
#: ``||got - want|| / ||want||`` over its D values (:func:`row_rel_err`).
#: Both sides round the output to bfloat16, whose step is at most 2^-7 of a
#: value, so outputs one step apart in every element give at most 2^-7 =
#: 0.0078.  Beside the absolute 3e-2, which is about the size of a typical
#: output at long S (|out| ~ sqrt(e/n) for n visible keys: 0.05 at S 1000,
#: 0.015 at S 32768) and alone would pass a layout fault.
FLASH_ROW_TOL = 1e-2


def row_rel_err(got, want) -> float:
    """Largest ``||got - want|| / ||want||`` over the rows (last axis)."""
    g, w = got.float(), want.float()
    return float(((g - w).norm(dim=-1)
                  / w.norm(dim=-1).clamp_min(1e-30)).max())


#: (B, Hq, Hkv, S) at D 128, causal, bfloat16: benchmarks/kernels_bench.py:30
FLASH_BENCH = [(8, 32, 8, 4096), (1, 32, 8, 32768)]

#: (B, S, H, D) at rwkv6-3b's width, bfloat16 r/k/v, float32 log_w and u:
#: benchmarks/kernels_bench.py:66
WKV_BENCH = (8, 4096, 40, 64)

#: (B, Hq, Hkv, S) at D 128, 64-token pages, bfloat16, every sequence full:
#: benchmarks/kernels_bench.py:41 (a 17.2 GB page store)
PAGED_BENCH = dict(B=128, Hq=32, Hkv=8, S=32768, D=128, page=64,
                   dtype="bfloat16")

#: (B, S, H, D, chunk, dtype): tests/test_kernels.py:96-101
WKV_CASES = [
    (2, 64, 2, 32, 16, "float32"),
    (1, 128, 4, 64, 64, "float32"),
    (2, 64, 2, 64, 32, "bfloat16"),
    (1, 96, 1, 32, 32, "float32"),
]


def make_flash_case(case, seed: int = 0) -> dict:
    """Numpy inputs of one flash-attention check, sequence-major
    ``(B, S, H, D)`` float32 arrays (the caller casts to ``dtype``), drawn
    as standard normals like the reference's test."""
    B, S, Hq, Hkv, D, causal, window, dtype, bq, bk = case
    rng = np.random.default_rng(seed)
    return dict(
        dtype=dtype, causal=causal, window=window, block_q=bq, block_k=bk,
        q=rng.standard_normal((B, S, Hq, D)).astype(np.float32),
        k=rng.standard_normal((B, S, Hkv, D)).astype(np.float32),
        v=rng.standard_normal((B, S, Hkv, D)).astype(np.float32))


def flash_tensors(c: dict, device="cpu", head_major: bool = True):
    """``(q, k, v)`` of a case on ``device`` in its dtype, head-major
    ``(B, H, S, D)`` contiguous (the kernel's layout) or sequence-major."""
    dt = getattr(torch, c["dtype"])
    out = []
    for n in ("q", "k", "v"):
        t = torch.from_numpy(c[n]).to(device=device, dtype=dt)
        out.append(t.transpose(1, 2).contiguous() if head_major else t)
    return tuple(out)


#: (B, S, H, D, chunk, dtype, log_w dtype) for the tensor-core instance
#: (``chunk_tc_bf16``): both head_dims, log_w in bfloat16 and float32, S of
#: 1 and 17 (one ragged chunk of 32), 40 (a full chunk and a ragged one), 96
#: (three chunks) and 4096 (128, the bench's length) at a narrow B * H; B > 1
#: with a ragged S, where rows past S of batch b would be batch b + 1's; and
#: callers' chunks of 1 to 96 (the kernel's own chunk is 32 whatever they
#: say).
WKV_TC_CASES = [
    (2, 1, 2, 64, 64, "bfloat16", "float32"),
    (3, 17, 2, 64, 17, "bfloat16", "float32"),
    (1, 17, 3, 32, 1, "bfloat16", "bfloat16"),
    (2, 40, 2, 32, 8, "bfloat16", "float32"),
    (2, 96, 2, 64, 32, "bfloat16", "bfloat16"),
    (1, 96, 2, 32, 96, "bfloat16", "float32"),
    (1, 4096, 2, 64, 64, "bfloat16", "float32"),
    (1, 4096, 1, 32, 64, "bfloat16", "bfloat16"),
]

#: wkv6 outputs of the tensor-core instance against the sequential float32
#: recurrence: the largest error of one (b, t, h) row relative to the row,
#: ``||got - want|| / ||want||`` over its D values (:func:`row_rel_err`).
#: The output is rounded to bfloat16 (at most 2^-8 of a value: 0.0039 a
#: row), and the two products that read the float32 state take it as a
#: bfloat16 operand (about 2^-9 relative an element, averaged over D terms
#: of either sign); 1e-2 leaves room for both.  Beside the scaled 3e-2,
#: which is measured against the largest output of the whole call and so
#: passes a row that is wrong by tens of percent wherever outputs are small
#: (early steps, strong decays).
WKV_ROW_TOL = 1e-2

#: log_w patterns of the strong-decay checks (``make_wkv_case(...,
#: decay=...)``): every step and channel at ``-exp(2.5)`` (w = 5e-6: a
#: product of eight such steps is below float32's smallest normal), and
#: channels alternating between -1e-4 (w ~ 1: the state only grows) and -12
def wkv_decay(name: str, shape) -> np.ndarray:
    """``log_w`` of shape ``(B, S, H, D)`` for a named decay pattern."""
    if name == "strong":
        return np.full(shape, -np.exp(2.5), np.float32)
    if name == "mixed":
        per_d = np.where(np.arange(shape[-1]) % 2 == 0, -1e-4, -12.0)
        return np.broadcast_to(per_d.astype(np.float32), shape).copy()
    raise ValueError(f"unknown decay pattern {name!r}")


WKV_DECAYS = ("strong", "mixed")


def make_wkv_case(case, seed: int = 0, decay: str | None = None) -> dict:
    """Numpy inputs of one wkv6 check, scaled as the reference's test:
    r, k, v standard normal x 0.5, ``log_w = -exp(0.5 N)`` (or the named
    ``decay`` pattern of :func:`wkv_decay`), u = 0.3 N.  A case is ``(B, S,
    H, D, chunk, dtype)`` (log_w float32) or has log_w's dtype seventh."""
    B, S, H, D, chunk, dtype = case[:6]
    w_dtype = case[6] if len(case) > 6 else "float32"
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, S, H, D)).astype(np.float32) * 0.5
               for _ in range(3))
    lw = -np.exp(rng.standard_normal((B, S, H, D)).astype(np.float32) * 0.5)
    if decay is not None:
        lw = wkv_decay(decay, (B, S, H, D))
    u = rng.standard_normal((H, D)).astype(np.float32) * 0.3
    return dict(dtype=dtype, w_dtype=w_dtype, chunk=chunk, r=r, k=k, v=v,
                log_w=lw, u=u)


def wkv_tensors(c: dict, device="cpu"):
    """``(r, k, v, log_w, u)`` on ``device``: r, k, v in the case's dtype,
    log_w in its own (float32 unless the case says otherwise, as the
    reference's test leaves it) and u in float32."""
    dt = getattr(torch, c["dtype"])
    f = [torch.from_numpy(c[n]).to(device=device, dtype=dt)
         for n in ("r", "k", "v")]
    wt = getattr(torch, c.get("w_dtype", "float32"))
    return (*f, torch.from_numpy(c["log_w"]).to(device=device, dtype=wt),
            torch.from_numpy(c["u"]).to(device))


def wkv_err(got, want) -> float:
    """Max abs difference after dividing both by ``max|want| + 1e-6`` (the
    reference's scaled ``atol``, tests/test_kernels.py:113-117)."""
    g, w = got.float(), want.float()
    scale = float(w.abs().max()) + 1e-6
    return float((g / scale - w / scale).abs().max())
