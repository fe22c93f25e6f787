"""The comparison that decides ``correct`` has to fail.

The control (the reference in float32 in the program's place) at a small
size, and a run driven through ``kvsimbench.run.run`` on the CPU with the
timed path broken underneath, once for each fault a cell can have: a step
that returns its state unchanged, half of the cells left out and filled
with the mean of the rest, and an answer altered where it is produced (a
cell's time by 1e-7 of itself; the reduction choosing another thread
count).  The cells run on one device, so there is no exchange between
chips to leave out.  A sound run on the same inputs comes out correct.
"""
import numpy as np
import pytest

from kvsimbench import bench, check, control, deployment, run
from repro_torch.core.sim import replay_torch
from repro_torch.core.sim import sweep as sweep_mod
from repro_torch.kernels import sched_step

SMALL = {"config": {"n_keys": 2000, "n_wl_ops": 800},
         "traffic": {"latencies_us": [0.5, 2.0, 4.0, 8.0], "threads": [3, 4],
                     "n_ops": 150}}
SEED = 2**33 + 5


def run_small(cell):
    return run.run(bench.cell(cell), SEED, 0.05, False, "cpu", SMALL)


@pytest.mark.parametrize("cell", ["hash_fig_closed", "lsm_fig_open"])
def test_sound_run_is_correct(cell):
    r = run_small(cell)
    assert r["correct"], r
    assert r["checks"]["value_gap"]["value"] <= 2**-52
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("cell", ["hash_fig_closed", "lsm_fig_open"])
def test_control_fails(cell):
    c = bench.cell(cell)
    inp = deployment.make(c["config_doc"], c["traffic_doc"], SEED, SMALL)
    numbers = control.control_numbers(inp, 3)
    assert not check.passed(numbers), numbers
    assert numbers["value_gap"]["value"] > 100 * check.LIMITS["value_gap"]
    assert numbers["trace_gap"]["value"] > 0


def test_state_left_unchanged_fails(monkeypatch):
    make = sched_step.make_substep

    def frozen(**kw):
        sub = make(**kw)

        def step(s, *args):
            return s
        step.flags = sub.flags
        return step

    monkeypatch.setattr(sched_step, "make_substep", frozen)
    r = run_small("hash_fig_closed")
    assert not r["correct"] and r["failed"] == r["attempted"] > 0


def test_half_the_cells_left_out_fails(monkeypatch):
    grid = replay_torch.sweep_grid

    def half(cfg, trace, latencies, cands, *a, **kw):
        n = len(latencies) // 2
        g = grid(cfg, trace, latencies[:n], cands, *a, **kw)
        fields = {}
        for f in ("throughput", "time", "mem_stall_total", "mem_accesses",
                  "p50", "p90", "p99", "lat_max", "lat_count", "missed"):
            v = getattr(g, f)
            if v is not None:
                rest = np.broadcast_to(v.mean(axis=0).astype(v.dtype),
                                       (len(latencies) - n,) + v.shape[1:])
                fields[f] = np.concatenate([v, rest])
        return replay_torch.GridResult(**{**g.__dict__, **fields})

    monkeypatch.setattr(replay_torch, "sweep_grid", half)
    r = run_small("lsm_fig_open")
    assert not r["correct"]
    assert r["checks"]["value_gap"]["value"] > check.LIMITS["value_gap"]


def test_answer_altered_where_produced_fails(monkeypatch):
    cohorts = replay_torch._run_cohorts

    def altered(*a, **kw):
        outs = cohorts(*a, **kw)
        for out in outs:
            out["time"] = out["time"] * (1 + 1e-7)
            out["throughput"] = out["throughput"] / (1 + 1e-7)
        return outs

    monkeypatch.setattr(replay_torch, "_run_cohorts", altered)
    r = run_small("hash_fig_closed")
    assert not r["correct"]
    assert r["checks"]["value_gap"]["value"] > check.LIMITS["value_gap"]


def test_other_thread_count_chosen_fails(monkeypatch):
    make_point = sweep_mod._make_point

    def last(L, candidates, evals):
        p = make_point(L, candidates, evals)
        j = len(candidates) - 1 if p.n_threads != candidates[-1] else 0
        p.n_threads, p.result = candidates[j], evals[j]
        return p

    monkeypatch.setattr(sweep_mod, "_make_point", last)
    r = run_small("hash_fig_closed")
    assert not r["correct"]
    assert r["checks"]["count_gap"]["value"] > 0
