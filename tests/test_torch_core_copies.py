"""The port's copies of the reference's framework-free modules (engines,
trace IR, workloads, the interpreter loops, arrival processes, the analytical
model) give the same results as the originals.  Contract: bit-exact -- they
are the same seeded pure-Python / numpy code."""
import dataclasses

import numpy as np
import pytest

from repro.core import latency_model as ref_lm
from repro.core.sim import SimConfig as RefSimConfig
from repro.core.sim import arrivals as ref_arr
from repro.core.sim import simulate as ref_simulate
from repro.core.sim import simulate_compiled as ref_simulate_compiled
from repro.core.sim import trace_source as ref_trace_source
from repro_torch.core import latency_model as lm
from repro_torch.core.sim import SimConfig
from repro_torch.core.sim import arrivals as arr
from repro_torch.core.sim import simulate, simulate_compiled, trace_source

from _torch_port_support import ENGINES, US, engine_trace

RESULT_FIELDS = ("ops", "time", "throughput", "mem_stall_total",
                 "mem_accesses", "missed_ops", "op_latencies", "load_stalls")


@pytest.fixture(scope="module", params=ENGINES)
def traces(request):
    return (engine_trace(request.param, 3_000, 900),
            engine_trace(request.param, 3_000, 900, port=False))


def test_run_trace_columns_byte_identical(traces):
    port, ref = traces
    for name in ("kinds", "durs", "bounds"):
        a, b = getattr(port.trace, name), getattr(ref.trace, name)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name
    assert port.io_per_op == ref.io_per_op
    assert port.mem_per_op == ref.mem_per_op
    assert dict(port.hit_stats) == dict(ref.hit_stats)


SIM_CASES = {
    "closed-loop": (dict(n_threads=12, P=12, seed=7, L_mem=3 * US, n_ssd=2,
                         R_io=250e3, L_switch=0.3 * US), {}),
    "two-cores": (dict(n_threads=6, n_cores=2, P=8, seed=5, L_mem=5 * US,
                       T_lock=0.1 * US, eps=0.02, rho=0.9), {}),
    "open-loop": (dict(n_threads=16, P=12, seed=3, L_mem=2 * US,
                       R_io=250e3),
                  dict(arrival=dict(kind="poisson", rate=40e3, seed=4),
                       collect_percentiles=True, deadline=500 * US)),
}


@pytest.mark.parametrize("case", sorted(SIM_CASES))
def test_simulate_compiled_identical(traces, case):
    port, ref = traces
    cfg_kw, extra = SIM_CASES[case]
    extra = dict(extra)
    kw_p, kw_r = dict(extra), dict(extra)
    if "arrival" in extra:
        spec = kw_p.pop("arrival")
        kw_r.pop("arrival")
        kw_p["arrivals"] = arr.generate_arrivals(spec, 700)
        kw_r["arrivals"] = ref_arr.generate_arrivals(spec, 700)
        assert np.array_equal(kw_p["arrivals"], kw_r["arrivals"])
    got = simulate_compiled(SimConfig(**cfg_kw), port.trace, 400,
                            collect_latency=True, **kw_p)
    want = ref_simulate_compiled(RefSimConfig(**cfg_kw), ref.trace, 400,
                                 collect_latency=True, **kw_r)
    for fld in RESULT_FIELDS:
        assert getattr(got, fld) == getattr(want, fld), fld
    if got.latency_summary is not None:
        assert got.latency_summary.to_dict() == \
            want.latency_summary.to_dict()
    assert dataclasses.asdict(SimConfig(**cfg_kw)) == \
        dataclasses.asdict(RefSimConfig(**cfg_kw))


def test_generic_loop_identical(traces):
    port, ref = traces
    cfg_kw = dict(n_threads=8, P=12, seed=9, L_mem=4 * US, R_io=250e3)
    got = simulate(SimConfig(**cfg_kw), trace_source(port.trace.to_ops()),
                   250)
    want = ref_simulate(RefSimConfig(**cfg_kw),
                        ref_trace_source(ref.trace.to_ops()), 250)
    for fld in RESULT_FIELDS:
        assert getattr(got, fld) == getattr(want, fld), fld


@pytest.mark.parametrize("spec", [
    dict(kind="poisson", rate=80e3, seed=1),
    dict(kind="bursty", rate=50e3, seed=2, on_fraction=0.3, period=0.004),
    dict(kind="diurnal", rate=60e3, seed=3, amplitude=0.5, period=0.01),
    dict(kind="mix", tenants=(dict(kind="poisson", rate=20e3, seed=5),
                              dict(kind="bursty", rate=30e3, seed=6))),
], ids=lambda s: s["kind"])
def test_generate_arrivals_identical(spec):
    a = arr.generate_arrivals(arr.ArrivalSpec.from_dict(spec), 3000)
    b = ref_arr.generate_arrivals(ref_arr.ArrivalSpec.from_dict(spec), 3000)
    assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert arr.ArrivalSpec.from_dict(spec).key() == \
        ref_arr.ArrivalSpec.from_dict(spec).key()


def test_histogram_helpers_identical():
    rng = np.random.default_rng(8)
    vals = np.concatenate([10.0 ** rng.uniform(-8, 1.5, 4000), [0.0, 1e-7]])
    assert (arr.HIST_LO, arr.HIST_BINS, arr.HIST_INV_LN_RATIO,
            arr.HIST_REL_ERROR) == (ref_arr.HIST_LO, ref_arr.HIST_BINS,
                                    ref_arr.HIST_INV_LN_RATIO,
                                    ref_arr.HIST_REL_ERROR)
    bins = arr.hist_bin(vals)
    assert np.array_equal(bins, ref_arr.hist_bin(vals))
    assert np.array_equal(arr.hist_bin_value(bins),
                          ref_arr.hist_bin_value(bins))
    counts = np.bincount(bins, minlength=arr.HIST_BINS).astype(np.float64)
    got = arr.summarize_hist(counts, float(vals.max()), missed=3)
    want = ref_arr.summarize_hist(counts, float(vals.max()), missed=3)
    assert got.to_dict() == want.to_dict()
    ex = arr.summarize_exact(vals.tolist(), missed=2)
    assert ex.to_dict() == ref_arr.summarize_exact(vals.tolist(),
                                                   missed=2).to_dict()


def test_latency_model_identical(traces):
    port, ref = traces
    from repro.core.engines import EngineTimes as RefTimes
    from repro_torch.core.engines import EngineTimes
    p = port.op_params(EngineTimes(), P=12, T_sw=0.05 * US)
    r = ref.op_params(RefTimes(), P=12, T_sw=0.05 * US)
    assert dataclasses.asdict(p) == dataclasses.asdict(r)
    L = np.linspace(0.1, 10, 23) * US
    for name in ("theta_prob_inv", "theta_mask_inv", "theta_best_inv"):
        a, b = getattr(lm, name)(L, p), getattr(ref_lm, name)(L, r)
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes(), name
