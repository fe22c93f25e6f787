"""Differential conformance: the backend equivalence-contract table plus
a seeded Scenario fuzzer that enforces it.

The port's simulation backends realize one prefetch+IO model: the generic
event loop (``simulate``), the compiled fast loop (``simulate_compiled``),
and the device grid (``replay_torch.sweep_grid``), whose steps run as the
fused CUDA kernel on the card or as the plain PyTorch step.  The
*contracts* between backend pairs -- which pairs are bit-identical and
which are tolerance-bound, and at what op count the tolerance was
measured -- live here and nowhere else (:data:`CONTRACTS` and the
constants it is built from); the tests, the fuzzer and the smoke run on
the card all consume the same table, so they cannot drift.

Two layers:

* **Contract table** -- :class:`EquivalenceContract` rows keyed by pair
  name.  Bit-identical pairs (``generic-vs-compiled``,
  ``torch-kernel-vs-plain``, ``trivial-cluster``) carry no tolerance;
  tolerance pairs (``torch-vs-loop``, ``cluster-torch-vs-loop``) carry a
  throughput bound documented at a reference op count plus tail bounds.
  Sampling noise between the loop's Mersenne stream and the grid's
  counter RNG scales like ``1/sqrt(n_ops)``, so :func:`grid_tol` /
  :func:`tail_tol` scale a documented bound to any cell size -- ``0.01``
  at 20k ops, ``0.02`` at 5k ops and so on are all one formula.

* **Fuzzer** -- :func:`scenario_for_seed` samples a small frozen
  :class:`~repro_torch.core.experiment.Scenario` across engines x
  workloads x devices x arrivals x clusters; :func:`check_scenario` runs
  it through every applicable backend via ``Experiment.run()`` and diffs
  the artifacts against the contract table; :func:`shrink_scenario`
  greedily minimizes a failing spec; :func:`write_repro` emits the shrunk
  spec as a plain scenario JSON into ``examples/conformance/``, which
  doubles as the checked-in seed corpus that :func:`replay_corpus`
  re-runs green.

The grid checks run on ``device`` (default ``"cuda"``, which raises
without a card); ``device="cpu"`` runs the plain PyTorch step on the
host, where the ``kernel`` check cannot run and raises ``ValueError``:
a CPU caller names ``checks=("compiled", "torch")``.

CLI (see ``python -m repro_torch.core.conformance --help``)::

    python -m repro_torch.core.conformance fuzz --seeds 25
    python -m repro_torch.core.conformance replay examples/conformance
    python -m repro_torch.core.conformance replay examples/conformance \
        --device cpu --checks compiled,torch
    python -m repro_torch.core.conformance sample 17 --out scenario.json
"""
from __future__ import annotations

import argparse
import math
import random
import sys
from dataclasses import dataclass, replace
from pathlib import Path
from typing import Callable, Iterable, Sequence

from .experiment import Experiment, RunArtifact, RunOptions, Scenario

__all__ = [
    "EquivalenceContract",
    "CONTRACTS",
    "GRID_TOL",
    "GRID_REF_OPS",
    "P50_TOL",
    "P99_TOL",
    "P50_BIMODAL_GATE",
    "TAIL_REF_OPS",
    "CLUSTER_TOL",
    "CLUSTER_TAIL_TOL",
    "CLUSTER_REF_OPS",
    "grid_tol",
    "tail_tol",
    "ConformanceFailure",
    "CHECK_NAMES",
    "KERNEL_CLIP_OPS",
    "check_scenario",
    "scenario_for_seed",
    "sample_scenario",
    "shrink_scenario",
    "write_repro",
    "replay_corpus",
    "fuzz",
]

# -- contract constants ------------------------------------------------------
#
# torch-vs-loop throughput: the two backends draw jitter from different
# RNG streams, so per-cell throughput differs by sampling noise ~ 1/sqrt(n).
# The documented bound is 1% on the paper grid's 20k-op cells
# (docs/SIMULATION.md); grid_tol() scales it to other cell sizes.
GRID_TOL = 0.01               # relative throughput bound at GRID_REF_OPS
GRID_REF_OPS = 20_000         # paper-grid cell size the bound is measured at

# torch-vs-loop tails: the grid's log-histogram percentiles vs the loop's
# exact nearest-rank percentiles, documented at 400-op open-loop cells.
P50_TOL = 0.08                # relative p50 bound at TAIL_REF_OPS
P99_TOL = 0.12                # relative p90/p99 bound at TAIL_REF_OPS
TAIL_REF_OPS = 400
# p50 is only comparable on unimodal sojourn distributions: when the mass
# splits into a fast hit mode and a slow IO mode, the median rides the
# boundary and nearest-rank vs histogram quantiles legitimately disagree.
# Gate: compare p50 only when p90 < P50_BIMODAL_GATE * p50.
P50_BIMODAL_GATE = 1.5

# cluster torch-vs-loop: fleet throughput sums per-node cells, which
# averages the per-node noise down; documented at 800-op fleet sweeps
# (tests/test_torch_cluster.py).  Fleet tails use one bound for p50 and p99.
CLUSTER_TOL = 0.01
CLUSTER_TAIL_TOL = 0.10
CLUSTER_REF_OPS = 800


def grid_tol(n_ops: int, *, base: float = GRID_TOL,
             ref_ops: int = GRID_REF_OPS, slack: float = 1.0) -> float:
    """The grid-vs-loop relative throughput bound at a given cell size.

    Sampling noise between the two RNG streams scales like
    ``1/sqrt(n_ops)``, so the bound documented at ``ref_ops`` widens by
    ``sqrt(ref_ops / n_ops)`` for smaller cells (and never tightens below
    ``base`` for larger ones).  ``slack`` multiplies the result -- tests
    use small slacks for measured headroom, the fuzzer a larger one
    because it samples far outside the tuned grids.
    """
    return slack * base * max(1.0, math.sqrt(ref_ops / max(n_ops, 1)))


def tail_tol(n_ops: int, *, base: float,
             ref_ops: int = TAIL_REF_OPS, slack: float = 1.0) -> float:
    """Scale a documented tail-percentile bound to a given cell size."""
    return slack * base * max(1.0, math.sqrt(ref_ops / max(n_ops, 1)))


@dataclass(frozen=True)
class EquivalenceContract:
    """One row of the backend equivalence matrix.

    ``bit_identical`` pairs must agree byte-for-byte; tolerance pairs
    carry a relative ``throughput_tol`` documented at ``ref_ops``
    simulated ops per cell (scale with :func:`grid_tol`) and tail
    bounds ``p50_tol`` / ``p99_tol`` (p90 shares the p99 bound; p50 is
    gated by :data:`P50_BIMODAL_GATE`).
    """

    name: str
    pair: tuple
    bit_identical: bool
    throughput_tol: float | None = None
    ref_ops: int | None = None
    p50_tol: float | None = None
    p99_tol: float | None = None
    tail_ref_ops: int | None = None
    why: str = ""


CONTRACTS: dict[str, EquivalenceContract] = {
    c.name: c for c in (
        EquivalenceContract(
            name="generic-vs-compiled",
            pair=("simulate", "simulate_compiled"),
            bit_identical=True,
            why="same event loop, same RNG draw order; the compiled loop "
                "is a mechanical specialization",
        ),
        EquivalenceContract(
            name="torch-kernel-vs-plain",
            pair=("sweep_grid(use_kernel=True)",
                  "sweep_grid(use_kernel=False)"),
            bit_identical=True,
            why="the fused CUDA step kernel (built with -fmad=false) "
                "computes the same lockstep update as the plain PyTorch "
                "step on the card, same float64 operations in the same order",
        ),
        EquivalenceContract(
            name="trivial-cluster",
            pair=("sweep_cluster(n_nodes=1)", "sweep_latency"),
            bit_identical=True,
            why="a 1-node fleet routes every op to node 0 with no route "
                "hop; the per-node cell is the single-host cell",
        ),
        EquivalenceContract(
            name="torch-vs-loop",
            pair=("sweep_grid", "simulate_compiled"),
            bit_identical=False,
            throughput_tol=GRID_TOL, ref_ops=GRID_REF_OPS,
            p50_tol=P50_TOL, p99_tol=P99_TOL, tail_ref_ops=TAIL_REF_OPS,
            why="different jitter RNG streams (Mersenne vs counter) and "
                "histogram vs exact percentiles; noise ~ 1/sqrt(n_ops)",
        ),
        EquivalenceContract(
            name="cluster-torch-vs-loop",
            pair=("sweep_cluster(backend='torch')",
                  "sweep_cluster(backend='loop')"),
            bit_identical=False,
            throughput_tol=CLUSTER_TOL, ref_ops=CLUSTER_REF_OPS,
            p50_tol=CLUSTER_TAIL_TOL, p99_tol=CLUSTER_TAIL_TOL,
            tail_ref_ops=CLUSTER_REF_OPS,
            why="fleet throughput sums per-node cells (noise averages "
                "down); fleet tails merge per-node histograms",
        ),
    )
}

# The fuzzer samples far outside the tuned benchmark grids (tiny cells,
# skewed clusters, deadline-censored tails), so it widens the documented
# bounds by a fixed slack on top of the 1/sqrt(n) scaling.  The cluster
# slack is largest: a skewed partition concentrates a fuzz cell's few
# hundred ops onto one hot node, so the effective per-cell sample is far
# smaller than the fleet total the 1/sqrt(n) scaling sees.
FUZZ_SLACK = 2.0
FUZZ_TAIL_SLACK = 1.5
FUZZ_CLUSTER_SLACK = 4.0

# Tails are only contract-comparable while service time dominates the
# sojourn.  Once the cell runs near or past saturation, queueing delay
# amplifies any throughput difference between the two RNG streams into
# unbounded tail divergence (rho/(1-rho) sensitivity), so the fuzzer
# skips tail comparison when the reference p99 exceeds this multiple of
# the cell's service scale (n_threads / throughput, the closed-loop
# per-op latency).  Throughput comparison -- which stays robust under
# overload -- still applies to those cells.
TAIL_QUEUE_GATE = 3.0

# Peaky open-loop arrivals (bursty on/off, diurnal with a deep swing)
# concentrate the tail mass into the burst peak: at a few hundred ops the
# p99 is decided by one or two peak-phase samples, which different
# service-RNG streams place differently.  Skip tail comparison for such
# rows unless the sample is large enough to average over phases.
PEAKY_TAIL_MIN_OPS = 400
DIURNAL_PEAKY_AMPLITUDE = 0.5

# The plain step runs one small PyTorch operation after another (about a
# millisecond a step on the card), so the kernel-vs-plain bit-identity
# check clips the scenario to one grid cell and at most this many ops --
# the contract is per-cell, clipping loses no coverage.
KERNEL_CLIP_OPS = 120


# -- differential checks -----------------------------------------------------

@dataclass(frozen=True)
class ConformanceFailure:
    """One contract violation (or crash) found by :func:`check_scenario`."""

    check: str
    contract: str
    message: str
    scenario: Scenario

    def __str__(self) -> str:
        return (f"[{self.check}] {self.contract}: {self.message} "
                f"(scenario {self.scenario.display_name})")


def _run(sc: Scenario, device, **opts) -> RunArtifact:
    opts.setdefault("collect_percentiles", True)
    # One process: a fuzz scenario has at most 4 cells, and once the card
    # is initialised a loop pool has to start from a forkserver that
    # re-imports the caller's main module -- more than the cells cost.
    # The loop's cells are identical either way.
    opts.setdefault("processes", 1)
    return Experiment(sc, RunOptions(device=device, **opts)).run()


def _rel(a: float, b: float) -> float:
    return abs(a - b) / abs(a) if a else (0.0 if not b else math.inf)


def _is_cluster(sc: Scenario) -> bool:
    cl = sc.cluster_spec()
    return cl is not None and cl.n_nodes > 1


def _row_core(row) -> dict:
    """The backend-determined slice of a row: what bit-identity compares.

    ``model_throughput`` is analytical (identical by construction but
    computed via the shares path on cluster rows) and ``nodes`` is absent
    on single-host rows, so both stay out of the cross-path comparison.
    """
    return {
        "L_us": row.L_us,
        "n_threads": row.n_threads,
        "throughput": row.throughput,
        "per_thread": row.per_thread,
        "tail": row.tail,
    }


def _check_compiled(sc: Scenario, device) -> list[ConformanceFailure]:
    """generic-vs-compiled bit-identity; on single-host scenarios also
    trivial-cluster degeneracy (the 1-node generic fleet must reproduce
    the compiled single-host sweep byte-for-byte, covering both
    contracts in one diff)."""
    ref = _run(sc, device, backend="loop")
    if _is_cluster(sc):
        contract = "generic-vs-compiled"
        other = _run(sc, device, backend="generic")
    else:
        contract = "trivial-cluster"
        other = _run(replace(sc, cluster={"n_nodes": 1}), device,
                     backend="generic")
    fails = []
    for i, (rr, gr) in enumerate(zip(ref.rows, other.rows)):
        a, b = _row_core(rr), _row_core(gr)
        if a != b:
            diff = [k for k in a if a[k] != b[k]]
            fails.append(ConformanceFailure(
                "compiled", contract,
                f"row {i} ({rr.label()}) differs on {diff}: "
                f"{ {k: (a[k], b[k]) for k in diff} }", sc))
    return fails


def _tail_fails(ref_tail, got_tail, *, p50_tol, p99_tol, check, contract,
                label, sc) -> list[ConformanceFailure]:
    fails = []
    if not ref_tail or not got_tail:
        return fails

    def val(t, fld):
        v = t.get(fld)
        return v if isinstance(v, (int, float)) and v > 0 else None

    for fld in ("p90_us", "p99_us"):
        a, b = val(ref_tail, fld), val(got_tail, fld)
        if a and b and _rel(a, b) > p99_tol:
            fails.append(ConformanceFailure(
                check, contract,
                f"{label} {fld}: {a:.3g} vs {b:.3g} "
                f"(rel {_rel(a, b):.3f} > {p99_tol:.3f})", sc))
    a50, b50 = val(ref_tail, "p50_us"), val(got_tail, "p50_us")
    a90 = val(ref_tail, "p90_us")
    unimodal = a50 and a90 and a90 < P50_BIMODAL_GATE * a50
    if a50 and b50 and unimodal and _rel(a50, b50) > p50_tol:
        fails.append(ConformanceFailure(
            check, contract,
            f"{label} p50_us: {a50:.3g} vs {b50:.3g} "
            f"(rel {_rel(a50, b50):.3f} > {p50_tol:.3f})", sc))
    return fails


def _peaky_arrival(sc: Scenario) -> bool:
    """True for arrival processes whose tail mass sits in a burst peak
    (see :data:`PEAKY_TAIL_MIN_OPS`)."""
    arr = sc.arrival or {}
    kind = arr.get("kind")
    if kind == "bursty":
        return True
    return (kind == "diurnal"
            and arr.get("amplitude", 0.0) >= DIURNAL_PEAKY_AMPLITUDE)


def _queueing_dominated(row, n_nodes: int) -> bool:
    """True when the row's sojourn tail is queueing- rather than
    service-dominated (see :data:`TAIL_QUEUE_GATE`)."""
    tail = row.tail or {}
    p99 = tail.get("p99_us")
    if not isinstance(p99, (int, float)) or row.throughput <= 0:
        return False
    svc_us = 1e6 * row.n_threads * n_nodes / row.throughput
    return p99 > TAIL_QUEUE_GATE * svc_us


def _check_torch(sc: Scenario, device) -> list[ConformanceFailure]:
    """torch grid vs compiled loop within the contract's scaled tolerance.

    Per-thread cells are compared cell-wise (winning thread counts may
    legitimately differ when two candidates sit within noise of each
    other); the winner's throughput and tails are compared only when both
    backends picked the same candidate.
    """
    ref = _run(sc, device, backend="loop")
    grid = _run(sc, device, backend="torch")
    if _is_cluster(sc):
        contract = CONTRACTS["cluster-torch-vs-loop"]
        n_nodes = sc.cluster_spec().n_nodes
        tol = grid_tol(sc.n_ops, base=contract.throughput_tol,
                       ref_ops=contract.ref_ops, slack=FUZZ_CLUSTER_SLACK)
    else:
        contract = CONTRACTS["torch-vs-loop"]
        n_nodes = 1
        tol = grid_tol(sc.n_ops, slack=FUZZ_SLACK)
    p50 = tail_tol(sc.n_ops, base=contract.p50_tol,
                   ref_ops=contract.tail_ref_ops, slack=FUZZ_TAIL_SLACK)
    p99 = tail_tol(sc.n_ops, base=contract.p99_tol,
                   ref_ops=contract.tail_ref_ops, slack=FUZZ_TAIL_SLACK)
    fails = []
    for i, (rr, jr) in enumerate(zip(ref.rows, grid.rows)):
        lbl = f"row {i} ({rr.label()})"
        ra, ja = dict(rr.per_thread), dict(jr.per_thread)
        for n in sorted(set(ra) & set(ja)):
            r = _rel(ra[n], ja[n])
            if r > tol:
                fails.append(ConformanceFailure(
                    "torch", contract.name,
                    f"{lbl} per_thread[{n}]: {ra[n]:.6g} vs {ja[n]:.6g} "
                    f"(rel {r:.4f} > {tol:.4f})", sc))
        if rr.n_threads == jr.n_threads:
            r = _rel(rr.throughput, jr.throughput)
            if r > tol:
                fails.append(ConformanceFailure(
                    "torch", contract.name,
                    f"{lbl} throughput: {rr.throughput:.6g} vs "
                    f"{jr.throughput:.6g} (rel {r:.4f} > {tol:.4f})", sc))
            skip_tails = (_queueing_dominated(rr, n_nodes)
                          or (_peaky_arrival(sc)
                              and sc.n_ops < PEAKY_TAIL_MIN_OPS))
            if not skip_tails:
                fails.extend(_tail_fails(
                    rr.tail, jr.tail, p50_tol=p50, p99_tol=p99,
                    check="torch", contract=contract.name, label=lbl,
                    sc=sc))
    return fails


def _kernel_clip(sc: Scenario) -> Scenario:
    return replace(
        sc,
        latencies_us=(sc.latencies_us[0],),
        thread_candidates=(sc.thread_candidates[0],),
        n_ops=min(sc.n_ops, KERNEL_CLIP_OPS),
    )


def _require_card(device) -> None:
    import torch

    if torch.device(device).type != "cuda":
        raise ValueError(
            f"the kernel check compares the fused CUDA step with the plain "
            f"step on the card and cannot run on device={device!r}; on the "
            f"host name checks=('compiled', 'torch')")


def _check_kernel(sc: Scenario, device) -> list[ConformanceFailure]:
    """Fused CUDA kernel vs plain PyTorch step bit-identity on one clipped
    cell, both on the card."""
    _require_card(device)
    clip = _kernel_clip(sc)
    ref = _run(clip, device, backend="torch", use_kernel=False)
    ker = _run(clip, device, backend="torch", use_kernel=True)
    fails = []
    for i, (rr, pr) in enumerate(zip(ref.rows, ker.rows)):
        a, b = _row_core(rr), _row_core(pr)
        if a != b:
            diff = [k for k in a if a[k] != b[k]]
            fails.append(ConformanceFailure(
                "kernel", "torch-kernel-vs-plain",
                f"row {i} ({rr.label()}) differs on {diff}: "
                f"{ {k: (a[k], b[k]) for k in diff} }", sc))
    return fails


_CHECKS: dict[str, Callable[[Scenario, object], list]] = {
    "compiled": _check_compiled,
    "torch": _check_torch,
    "kernel": _check_kernel,
}
CHECK_NAMES = tuple(_CHECKS)


def check_scenario(sc: Scenario,
                   checks: Sequence[str] = CHECK_NAMES,
                   device="cuda") -> list[ConformanceFailure]:
    """Run the differential checks on ``device``; a crash inside a check is
    itself a conformance failure (the backends must *run* everywhere the
    Scenario space is valid, not just agree where they run).  An unknown
    check, and the ``kernel`` check off the card, raise ``ValueError``
    before anything runs; ``device="cuda"`` without a card raises
    ``RuntimeError``."""
    from .sim.replay_torch import resolve_device

    unknown = [name for name in checks if name not in _CHECKS]
    if unknown:
        raise ValueError(f"unknown check(s) {unknown}; valid: {CHECK_NAMES}")
    device = resolve_device(device)
    if "kernel" in checks:
        _require_card(device)
    fails: list[ConformanceFailure] = []
    for name in checks:
        try:
            fails.extend(_CHECKS[name](sc, device))
        except Exception as e:  # noqa: BLE001 -- crash == failure
            fails.append(ConformanceFailure(
                name, "crash", f"{type(e).__name__}: {e}", sc))
    return fails


# -- scenario sampling -------------------------------------------------------

# Every registered engine is fair game; the tiny key/op counts below keep
# even the heaviest traces sub-second.
ENGINE_POOL = (
    "hash-index", "open-addressing", "tree-index", "lsm", "slab-cache",
    "two-tier-cache", "cachelib-like", "memcached-like", "rocksdb-like",
    "aerospike-like",
)
_WORKLOAD_POOL = ("uniform", "zipf", "gaussian", "drifting-zipf")


def sample_scenario(rng: random.Random, seed: int = 0) -> Scenario:
    """One random small Scenario covering the fuzz axes.

    Sizes are chosen so a full differential pass (6 ``Experiment.run()``
    calls, four of them on the grid) stays in the seconds range: <= 3k keys, <= 1k
    trace ops, <= 600 simulated ops per cell, <= 4 grid cells.
    """
    spec: dict = dict(engine=rng.choice(ENGINE_POOL),
                      name=f"fuzz-{seed}",
                      seed=rng.randrange(1, 64),
                      n_keys=rng.choice((1500, 3000)),
                      n_wl_ops=rng.choice((600, 1000)),
                      n_ssd=rng.choice((1, 2)),
                      n_cores=rng.choice((1, 1, 2)))
    if rng.random() < 0.5:
        wname = rng.choice(_WORKLOAD_POOL)
        wkw: dict = {"seed": rng.randrange(5)}
        if wname == "zipf":
            wkw["exponent"] = rng.choice((0.9, 1.1, 1.3))
        elif wname == "gaussian":
            wkw["sigma_frac"] = rng.choice((0.05, 0.15))
        elif wname == "drifting-zipf":
            wkw["n_segments"] = rng.choice((4, 8))
        if rng.random() < 0.5:
            wkw["read_write"] = rng.choice(((1, 0), (2, 1), (1, 1)))
        spec.update(workload=wname, workload_kwargs=wkw)
    if spec["n_ssd"] > 1:
        spec["L_switch_us"] = rng.choice((0.0, 0.3))
    if rng.random() < 0.5:
        spec["R_io"] = rng.choice((150e3, 250e3))
    if rng.random() < 0.3:
        spec["T_lock_us"] = rng.choice((0.2, 0.5))
    lats = rng.sample((0.5, 1.0, 2.0, 5.0, 8.0), k=rng.choice((1, 2)))
    if rng.random() < 0.25:
        # tail-latency mixture entry (CXL-style slow outliers)
        lats[0] = ((1.0, 0.9), (10.0, 0.1))
    spec["latencies_us"] = tuple(lats)
    spec["thread_candidates"] = tuple(sorted(
        rng.sample((4, 8, 12, 16), k=rng.choice((1, 2)))))
    spec["n_ops"] = rng.choice((240, 400, 600))
    kind = rng.choice(("closed", "poisson", "bursty", "diurnal"))
    if kind != "closed":
        arr: dict = {"kind": kind,
                     "rate": rng.choice((80e3, 160e3, 240e3)),
                     "seed": rng.randrange(4)}
        if kind == "bursty":
            arr.update(on_fraction=0.25, period=0.005)
        elif kind == "diurnal":
            arr.update(amplitude=0.8, period=0.01)
        if rng.random() < 0.25:
            arr["deadline"] = 0.003
        spec["arrival"] = arr
    if rng.random() < 0.35:
        n_nodes = rng.choice((2, 3, 4))
        cl: dict = {"n_nodes": n_nodes,
                    "partition": rng.choice(("hash", "range")),
                    "L_route_us": rng.choice((0.0, 5.0))}
        if rng.random() < 0.5:
            cl.update(replication=2, replica_policy="spread")
        if rng.random() < 0.3:
            cl["node_overrides"] = {
                "1": {"io_degrade": 4.0, "T_degrade_us": 400.0}}
        if rng.random() < 0.25:
            cl["migrate"] = {"shard": 0, "to": n_nodes - 1, "at_frac": 0.5}
        spec["cluster"] = cl
    return Scenario(**spec)


def scenario_for_seed(seed: int) -> Scenario:
    """The deterministic Scenario for a fuzz seed (stable across runs and
    machines -- ``random.Random`` is a versioned PRNG)."""
    return sample_scenario(random.Random(0x5EED ^ (seed * 2654435761)),
                           seed)


# -- shrinking ---------------------------------------------------------------

def _reductions(sc: Scenario) -> Iterable[tuple[str, Scenario]]:
    """Candidate one-step simplifications, most structural first."""

    def attempt(name, **kw):
        try:
            return name, replace(sc, **kw)
        except (ValueError, TypeError):
            return None

    cands = []
    if sc.cluster:
        cands.append(attempt("drop-cluster", cluster={}))
        cl = dict(sc.cluster)
        if cl.get("migrate"):
            cands.append(attempt(
                "drop-migrate", cluster={**cl, "migrate": {}}))
        if cl.get("node_overrides"):
            cands.append(attempt(
                "drop-overrides", cluster={**cl, "node_overrides": {}}))
        if int(cl.get("replication", 1)) > 1:
            cands.append(attempt("drop-replication", cluster={
                **cl, "replication": 1, "replica_policy": "primary"}))
    if sc.arrival:
        cands.append(attempt("drop-arrival", arrival={}))
        if dict(sc.arrival).get("deadline"):
            cands.append(attempt("drop-deadline", arrival={
                **dict(sc.arrival), "deadline": 0.0}))
    if len(sc.latencies_us) > 1:
        cands.append(attempt(
            "one-latency", latencies_us=(sc.latencies_us[0],)))
        cands.append(attempt(
            "last-latency", latencies_us=(sc.latencies_us[-1],)))
    if len(sc.thread_candidates) > 1:
        cands.append(attempt(
            "one-candidate", thread_candidates=(sc.thread_candidates[0],)))
    if sc.n_ops > 60:
        cands.append(attempt("halve-n_ops", n_ops=max(60, sc.n_ops // 2)))
    if sc.n_wl_ops > 200:
        cands.append(attempt(
            "halve-n_wl_ops", n_wl_ops=max(200, sc.n_wl_ops // 2)))
    if sc.n_keys > 500:
        cands.append(attempt(
            "halve-n_keys", n_keys=max(500, sc.n_keys // 2)))
    if sc.n_cores > 1:
        cands.append(attempt("one-core", n_cores=1))
    if sc.n_ssd > 1:
        cands.append(attempt("one-ssd", n_ssd=1, L_switch_us=0.0))
    if sc.R_io or sc.B_io:
        cands.append(attempt("no-token-clock", R_io=0.0, B_io=0.0))
    if sc.T_lock_us:
        cands.append(attempt("no-lock", T_lock_us=0.0))
    if sc.workload:
        cands.append(attempt(
            "default-workload", workload="", workload_kwargs={}))
    return [c for c in cands if c is not None]


def shrink_scenario(sc: Scenario, checks: Sequence[str] = CHECK_NAMES,
                    budget: int = 40,
                    device="cuda") -> tuple[Scenario, int]:
    """Greedily minimize a failing Scenario.

    Repeatedly tries the one-step reductions in order, accepting the
    first that still fails any of ``checks``, until a full pass accepts
    nothing or the evaluation ``budget`` (number of re-checks) runs out.
    Returns the smallest still-failing spec and the evaluations spent.
    """
    current, evals = sc, 0
    improved = True
    while improved and evals < budget:
        improved = False
        for name, cand in _reductions(current):
            if evals >= budget:
                break
            evals += 1
            if check_scenario(cand, checks, device=device):
                current = replace(cand, name=f"{sc.name}-shrunk")
                improved = True
                break
    return current, evals


def write_repro(sc: Scenario, check: str, out_dir: str | Path) -> Path:
    """Emit a failing (ideally shrunk) spec as plain scenario JSON.

    The file is a bare ``Scenario`` document, so either package's
    ``replay_corpus`` replays it; landing it in ``examples/conformance/``
    turns the repro into a permanent regression test.
    """
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"repro_{check}_{sc.name or 'scenario'}.json"
    path.write_text(sc.to_json() + "\n")
    return path


# -- corpus + CLI ------------------------------------------------------------

def replay_corpus(corpus_dir: str | Path,
                  checks: Sequence[str] = CHECK_NAMES,
                  verbose: bool = False,
                  device="cuda") -> list[ConformanceFailure]:
    """Re-run every ``*.json`` scenario in a corpus directory through the
    differential checks; returns all failures (empty == green)."""
    corpus_dir = Path(corpus_dir)
    paths = sorted(corpus_dir.glob("*.json"))
    if not paths:
        raise FileNotFoundError(f"no *.json scenarios in {corpus_dir}")
    fails: list[ConformanceFailure] = []
    for path in paths:
        sc = Scenario.from_json(path.read_text())
        got = check_scenario(sc, checks, device=device)
        fails.extend(got)
        if verbose:
            print(f"  {path.name}: "
                  f"{'FAIL x' + str(len(got)) if got else 'ok'}")
    return fails


def fuzz(n_seeds: int, seed_start: int = 0,
         checks: Sequence[str] = CHECK_NAMES,
         failures_dir: str | Path | None = None,
         shrink: bool = True, verbose: bool = False,
         device="cuda") -> list[ConformanceFailure]:
    """Run ``n_seeds`` sampled scenarios through the checks, shrinking
    and emitting a repro JSON for each failing seed."""
    all_fails: list[ConformanceFailure] = []
    for seed in range(seed_start, seed_start + n_seeds):
        sc = scenario_for_seed(seed)
        fails = check_scenario(sc, checks, device=device)
        if verbose:
            print(f"  seed {seed} ({sc.display_name}): "
                  f"{'FAIL x' + str(len(fails)) if fails else 'ok'}")
        if not fails:
            continue
        failing_checks = tuple(dict.fromkeys(f.check for f in fails))
        shrunk = sc
        if shrink:
            shrunk, evals = shrink_scenario(sc, failing_checks,
                                            device=device)
            if verbose:
                print(f"    shrunk after {evals} evals: "
                      f"{shrunk.to_dict()}")
        if failures_dir is not None:
            path = write_repro(shrunk, failing_checks[0], failures_dir)
            if verbose:
                print(f"    repro -> {path}")
        all_fails.extend(fails)
    return all_fails


def _parse_checks(spec: str) -> tuple:
    checks = tuple(s.strip() for s in spec.split(",") if s.strip())
    unknown = set(checks) - set(CHECK_NAMES)
    if unknown:
        raise argparse.ArgumentTypeError(
            f"unknown check(s) {sorted(unknown)}; valid: {CHECK_NAMES}")
    return checks


def main(argv: Sequence[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.core.conformance",
        description="Differential conformance fuzzer for the simulation "
                    "backends (see CONTRACTS in this module).")
    sub = ap.add_subparsers(dest="cmd", required=True)

    f = sub.add_parser("fuzz", help="sample seeds and check them")
    f.add_argument("--seeds", type=int, default=10)
    f.add_argument("--seed-start", type=int, default=0)
    f.add_argument("--checks", type=_parse_checks, default=CHECK_NAMES)
    f.add_argument("--failures", default=None, metavar="DIR",
                   help="emit shrunk repro JSONs here")
    f.add_argument("--no-shrink", action="store_true")

    r = sub.add_parser("replay", help="re-check a corpus directory")
    r.add_argument("corpus", help="directory of scenario *.json files")
    r.add_argument("--checks", type=_parse_checks, default=CHECK_NAMES)
    for p in (f, r):
        p.add_argument("--device", default="cuda",
                       help="device of the grid checks (default cuda; cpu "
                            "runs the plain step on the host, where the "
                            "kernel check cannot run)")

    s = sub.add_parser("sample", help="print the Scenario for a seed")
    s.add_argument("seed", type=int)
    s.add_argument("--out", default=None, metavar="FILE")

    args = ap.parse_args(argv)

    if args.cmd == "sample":
        sc = scenario_for_seed(args.seed)
        text = sc.to_json() + "\n"
        if args.out:
            Path(args.out).write_text(text)
            print(f"wrote {args.out}")
        else:
            print(text, end="")
        return 0

    if args.cmd == "replay":
        fails = replay_corpus(args.corpus, args.checks, verbose=True,
                              device=args.device)
    else:
        fails = fuzz(args.seeds, args.seed_start, args.checks,
                     failures_dir=args.failures,
                     shrink=not args.no_shrink, verbose=True,
                     device=args.device)
    for fail in fails:
        print(f"FAIL {fail}")
    print(f"{len(fails)} conformance failure(s)")
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
