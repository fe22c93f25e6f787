"""``benchmarks/sched_split_torch.py``: what it computes from shapes -- the
phase names against the kernel's, cycles as microseconds, the per-cohort
totals and the chain floor -- every variant's edit still finds its place in
the kernel's source, no card -> an error, and a module that imports neither
jax nor the reference package.  The timings themselves run on the card."""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmarks import sched_split_torch as ss
from repro_torch.kernels import sched_step as sk

ROOT = Path(__file__).resolve().parents[1]
SRC = (ROOT / "src" / "repro_torch" / "kernels" / "csrc"
       / "sched_step.cu").read_text()


def test_phases_are_the_kernels():
    assert ss.PHASES == sk.PROF_PHASES
    assert sk.PROF_COLUMNS == ss.PHASES + ("idle_skips", "launch_cycles")
    assert ss.CHAIN_PHASES == ("pop", "row_kd", "op_completion_se",
                               "clock_grant")


def test_cycles_to_us_and_chain_floor():
    assert ss.cycles_to_us(1980.0, 1980.0) == 1.0
    assert ss.cycles_to_us(np.array([990.0, 3960.0]), 1980.0).tolist() == \
        [0.5, 2.0]
    # 1024 steps of 1000 cycles at 2 GHz: 0.512 ms
    assert ss.chain_floor_ms(1000.0, 1024, 2000.0) == pytest.approx(0.512)


def test_split_rows_totals():
    """Two cohorts of 2 and 3 cells, 100 steps: means a step, shares, the
    chain's part, idle skips and launch cycles per step."""
    n = len(ss.PHASES)
    prof = np.zeros((5, n + 2), np.int64)
    prof[:2, :n] = [100, 200, 300, 400, 500, 600]      # cohort 0, a cell
    prof[:2, n] = 30
    prof[:2, n + 1] = 2500
    prof[2:, :n] = 1000
    prof[2:, n] = 0
    prof[2:, n + 1] = 7000
    rows = ss.split_rows(prof, [2, 3], steps=100, mhz=2000.0)
    a, b = rows
    assert (a["cells"], b["cells"]) == (2, 3)
    assert a["cycles_per_step"] == {p: c for p, c in zip(
        ss.PHASES, (1.0, 2.0, 3.0, 4.0, 5.0, 6.0))}
    assert a["total_cycles_per_step"] == 21.0
    assert a["chain_cycles_per_step"] == 10.0
    assert a["share"]["write"] == pytest.approx(6 / 21)
    assert a["idle_skips_per_step"] == 0.3
    assert a["launch_cycles_per_step"] == 25.0
    assert a["us_per_step"] == pytest.approx(21 / 2000)
    assert a["us_per_step_by_phase"]["pop"] == pytest.approx(1 / 2000)
    assert b["total_cycles_per_step"] == 60.0
    assert b["chain_cycles_per_step"] == 40.0
    assert b["idle_skips_per_step"] == 0.0
    assert sum(b["share"].values()) == pytest.approx(1.0)


@pytest.mark.parametrize("name", sorted({**ss.VARIANTS, **ss.NS_BODIES}))
def test_every_variant_edits_the_current_source(name):
    edits = ss.NS_BODIES if name in ss.NS_BODIES else ss.VARIANTS
    out = ss.variant_sources(SRC, edits)[name]
    assert (out == SRC) == (name == "kernel")
    # the argument block and the launcher are never touched
    for part in ("struct SchedArgs {", 'extern "C" int sched_step_launch'):
        head = SRC[SRC.index(part):]
        head = head[:head.index("};") if part.startswith("struct")
                    else len(head)]
        assert head in out


def test_undone_changes():
    v = ss.variant_sources(SRC)
    assert "__reduce_min_sync" in v["kernel"]
    assert "__shfl_xor_sync" not in v["kernel"]
    assert "__reduce_min_sync" not in v["shfl_min"]
    assert "clk_dev = io_rr % a.S;" in v["modulo"]
    assert "(ci0 + 1) % a.n_trace" in v["modulo"]
    assert "% a.S" not in v["kernel"].split("clk.start()")[1]
    assert "if (issue) {" in v["kernel"]
    assert "if (issue) {" not in v["slot_min_every_step"]
    assert "s_kd[2 * tid]" not in v["no_kd_cache"].split("clk.stamp(0)")[1] \
        .split("clk.stamp(1)")[0]
    se = v["no_se_ahead"]
    assert se.index("se_s = __ldg(a.se + 2 * (size_t)ci0)") < \
        se.index("clk.stamp(1)")
    assert "floor(span * INV_SPAN)" in v["span_unpack"].split(
        "clk.stamp(0)")[1]
    assert "(w <= now_v) ? wkey[j]" not in v["wake_keys_each_pop"]
    before = v["before"]
    for edit in ("shfl_min", "slot_min_every_step", "no_kd_cache",
                 "no_se_ahead",
                 "modulo", "span_unpack", "wake_keys_each_pop",
                 "uniform_draw_loads"):
        assert ss.VARIANTS[edit](SRC) != SRC
    assert "__reduce_min_sync" not in before
    assert "clk_dev = io_rr % a.S;" in before
    assert "switch (co.NS)" in before
    for n in (1, 2, 4, 8):
        body = ss.variant_sources(SRC, ss.NS_BODIES)[f"ns{n}"]
        assert "switch (co.NS)" not in body
        assert f"run_cell<{n}, PROF>(a, co, g, smem);" in body


def test_edits_refuse_a_source_they_do_not_fit():
    with pytest.raises(ValueError):
        ss.variant_sources("// not the kernel\n")


def test_ptxas_notes_by_instance():
    log = "\n".join([
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_117sched_step_kernelILb0EEEv10SchedArgs' for "
        "'sm_90a'",
        "ptxas info    : Function properties for _ZN...ILb0E...",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 72 registers, used 1 barriers",
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_117sched_step_kernelILb1EEEv10SchedArgs' for "
        "'sm_90a'",
        "ptxas info    : Used 90 registers, used 1 barriers"])
    notes = ss.ptxas_notes(log)
    assert notes["normal"]["ptxas"] == "Used 72 registers, used 1 barriers"
    assert notes["normal"]["spills"].startswith("0 bytes stack frame")
    assert notes["profiling"]["ptxas"].startswith("Used 90 registers")


def test_split_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the split runs")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ss.main([])


def test_module_imports_neither_jax_nor_the_reference():
    src = (ROOT / "benchmarks" / "sched_split_torch.py").read_text()
    assert not re.search(r"^\s*(import|from)\s+(jax|jaxlib|repro|benchmarks"
                         r"\.common)(\.|\s|$)", src, re.MULTILINE)
    child = ("import json, sys; import benchmarks.sched_split_torch; "
             "print(json.dumps(sorted(m for m in sys.modules if "
             "m.split('.')[0] in ('jax', 'jaxlib', 'ml_dtypes', 'repro'))))")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", child], capture_output=True,
                         text=True, env=env, timeout=300, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
