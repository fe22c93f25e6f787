"""``benchmarks.paper_figs_torch`` against the reference's
``benchmarks.paper_figs``: on the loop backend every figure prints the
reference's rows byte for byte, save fig11(a)(b), whose one repeated op the
port sweeps as a one-op trace (departure C16) and which agree within the
backend tolerance; and that one-op trace on the torch grid agrees with the
loop."""
import random
import re

import pytest

from benchmarks import common_torch
from benchmarks import paper_figs as ref_figs
from benchmarks import paper_figs_torch as port_figs
from repro_torch.core.conformance import grid_tol
from repro_torch.core.sim import SimConfig, microbenchmark_source, sweep_latency
from repro_torch.core.sim import replay_torch as rt

US = 1e-6
NAMES = [f.__name__ for f in ref_figs.ALL]


def test_same_functions_in_the_same_order():
    assert [f.__name__ for f in port_figs.ALL] == NAMES
    assert len(NAMES) == 12


def _rows(fn, capsys):
    fn()
    return capsys.readouterr().out.splitlines()


_NUM = re.compile(r"^([a-z_]+)=([-+0-9.e]+)$")


def _fields(derived):
    return dict(_NUM.match(kv).groups() for kv in derived.split(";"))


@pytest.mark.parametrize("name", NAMES)
def test_loop_rows_equal_the_reference(name, capsys, monkeypatch):
    monkeypatch.setattr(common_torch, "BACKEND", "loop")
    want = _rows(getattr(ref_figs, name), capsys)
    got = _rows(getattr(port_figs, name), capsys)
    assert len(want) == len(got) and want
    if name != "fig11_microbenchmark":
        assert got == want
        return
    # C16: the loop replays the one-op trace, not the callable
    tol = grid_tol(5000)
    for w, g in zip(want, got):
        wn, wus, wd = w.split(",")
        gn, gus, gd = g.split(",")
        assert gn == wn
        if float(wus):
            assert abs(float(gus) - float(wus)) / float(wus) <= tol, (w, g)
        wf, gf = _fields(wd), _fields(gd)
        assert wf.keys() == gf.keys()
        for k in wf:
            a, b = float(wf[k]), float(gf[k])
            if k == "max_abs_rel":       # |r - 1| moves by <= tol * r
                assert abs(a - b) <= tol * (1 + max(a, b)), (w, g)
            else:
                assert abs(a - b) / a <= tol, (w, g)


@pytest.mark.parametrize("io", [(1.5, 0.2, 1), (0.0, 0.0, 0)],
                         ids=["fig11a-op", "memory-only-op"])
def test_one_op_trace_on_the_grid_agrees_with_the_loop(io, monkeypatch):
    """The one-op trace of fig11(a) and the memory-only op of the O1 demo:
    the torch grid on the host within ``grid_tol(n_ops)`` of the loop, and
    the loop's trace within that of the reference's callable source.  The
    memory-only op has no random draw in its cells: every route gives the
    same throughput (the trace routes the same bits)."""
    monkeypatch.setattr(rt, "_EXIT_CHECK_CHUNKS", 1)
    pre, post, n_io = io
    src = microbenchmark_source(10, 0.1 * US, pre * US, post * US, n_io=n_io)
    op = [src(random.Random(0))]
    cfg, lats, n_ops = SimConfig(P=12, seed=5), [1 * US, 5 * US], 400

    def thr(source, **kw):
        return [pt.throughput for pt in
                sweep_latency(cfg, source, lats, [16], n_ops=n_ops, **kw)]

    callable_loop = thr(src, backend="loop")
    trace_loop = thr(op, backend="loop")
    grid = thr(op, backend="torch", device="cpu")
    tol = grid_tol(n_ops)
    for c, t, g in zip(callable_loop, trace_loop, grid, strict=True):
        assert abs(g - t) / t <= tol and abs(t - c) / c <= tol
        if n_io == 0:
            assert g == t and abs(t - c) / c < 1e-12
