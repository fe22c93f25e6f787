"""``benchmarks/kernels_bench_torch.py`` against the reference's
``benchmarks/kernels_bench.py``: the same rows with the same analytic FLOP
and byte counts (the same ``AI=`` field at every shape; the reference's time
column is a TPU model and is not compared), the same Theta-model rows when
given the TPU's peak, bounds at the H100's rates, no card -> an error, and a
module that imports neither jax nor the reference package."""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmarks import kernels_bench as ref_bench
from benchmarks import kernels_bench_torch as kb

ROOT = Path(__file__).resolve().parents[1]
NAMES = [name for name, _, _ in kb.analytic_rows()]


@pytest.fixture(scope="module")
def ref_rows():
    """``name -> derived`` of every row the reference prints."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        for fn in ref_bench.ALL:
            fn()
    rows = {}
    for line in buf.getvalue().splitlines():
        name, us, derived = line.split(",", 2)
        rows[name] = (float(us), derived)
    return rows


def _field(derived, key):
    return dict(kv.split("=", 1) for kv in derived.split(";"))[key]


@pytest.mark.parametrize("name", NAMES)
def test_same_rows_and_arithmetic_intensity_as_the_reference(ref_rows, name):
    flops, bytes_ = {n: (f, b) for n, f, b in kb.analytic_rows()}[name]
    assert name in ref_rows
    want = _field(ref_rows[name][1], "AI")
    assert kb.ai_field(name, flops, bytes_) == f"AI={want}"


def test_theta_rows_at_the_tpu_peak_are_the_reference_rows(ref_rows):
    """The port's copy of the paper's model gives the reference's numbers
    when fed the reference's TPU peak; the bench feeds it the H100's."""
    from repro.roofline.analysis import PEAK_FLOPS as TPU_PEAK
    for name, us, eff in kb.theta_rows(TPU_PEAK):
        ref_us, derived = ref_rows[name]
        assert f"{us:.4f}" == f"{ref_us:.4f}"
        assert f"eff={eff:.3f}" == derived
    assert {n for n, _, _ in kb.theta_rows()} == {
        n for n, _, _ in kb.theta_rows(TPU_PEAK)}


def test_h100_bounds():
    """max(flops / 989e12, bytes / 3.35e12), never the TPU's rates."""
    assert (kb.PEAK_FLOPS, kb.HBM_BW) == (989e12, 3.35e12)
    bounds = {n: kb.model_time(f, b) for n, f, b in kb.analytic_rows()}
    t, by = bounds["kernels/flash/B8S4096"]
    assert by == "compute" and t == pytest.approx(1.1117e-3, rel=1e-3)
    t, by = bounds["kernels/flash/B1S32768"]
    assert by == "compute" and t == pytest.approx(8.894e-3, rel=1e-3)
    t, by = bounds["kernels/paged_decode/B128S32768"]
    assert by == "hbm" and t == pytest.approx(5.128e-3, rel=1e-3)
    t, by = bounds["kernels/wkv6/B8S4096"]
    assert by == "hbm" and t == pytest.approx(2.504e-4, rel=1e-3)


def test_card_bound_is_the_one_bound_of_each_kernel():
    """The bound ``chip_smoke.py`` reports: the reference's counts where
    they are the kernel's (flash, paged); for wkv6 the bytes it really moves
    (float32 log_w and u) and its float32 operations at 67 TFLOP/s."""
    for name, flops, bytes_ in kb.analytic_rows():
        if "/wkv6/" in name:
            continue
        t, by = kb.model_time(flops, bytes_)
        assert kb.card_bound(flops, bytes_) == (
            t * 1e3, {"compute": "operations", "hbm": "bytes"}[by])
    B, S, H, D = kb.WKV_SHAPE
    flops, _ = kb.wkv6_counts(B, S, H, D)
    nbytes = kb.wkv6_card_bytes(B, S, H, D)
    assert nbytes == B * S * H * D * 12 + 4 * H * D
    ms, by = kb.card_bound(flops, nbytes, kb.PEAK_FLOPS_F32)
    assert by == "bytes" and ms == pytest.approx(0.30049, rel=1e-4)
    assert flops / kb.PEAK_FLOPS_F32 * 1e3 == pytest.approx(0.2454, rel=1e-3)


def test_shapes_are_the_shared_cases():
    import _torch_kernel_cases as cases
    assert kb.FLASH_SHAPES == tuple(cases.FLASH_BENCH)
    assert kb.WKV_SHAPE == cases.WKV_BENCH
    p = cases.PAGED_BENCH
    assert kb.PAGED_SHAPES == ((p["B"], p["Hq"], p["Hkv"], p["S"]),)
    assert (kb.D_ATTN, kb.PAGE) == (p["D"], p["page"])


@pytest.mark.parametrize("bench", kb.ALL, ids=lambda f: f.__name__)
def test_benches_raise_without_a_card(bench):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the bench runs")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench()


def test_module_imports_neither_jax_nor_the_reference():
    src = (ROOT / "benchmarks" / "kernels_bench_torch.py").read_text()
    assert not re.search(r"^\s*(import|from)\s+(jax|jaxlib|repro|benchmarks"
                         r"\.common)(\.|\s|$)", src, re.MULTILINE)
    child = ("import json, sys; import benchmarks.kernels_bench_torch; "
             "print(json.dumps(sorted(m for m in sys.modules if "
             "m.split('.')[0] in ('jax', 'jaxlib', 'ml_dtypes', 'repro'))))")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", child], capture_output=True,
                         text=True, env=env, timeout=300, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
