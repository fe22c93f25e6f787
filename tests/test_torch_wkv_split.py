"""``benchmarks/wkv_split_torch.py``: every variant's edit still finds its
place in the kernel's source and changes what it says it changes, the timed
order, no card -> an error, and a module that imports neither jax nor the
reference package.  The timings themselves run on the card only."""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmarks import wkv_split_torch as ws

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc" / "wkv6.cu"


@pytest.mark.parametrize("name", sorted(ws.VARIANTS))
def test_every_variant_edits_the_current_source(name):
    src = SRC.read_text()
    out = ws.variant_sources(src)[name]
    assert (out == src) == (name == "kernel")
    # the float32 instance's entry point is never touched
    tail = src[src.index("  if (D <= 0 || D > WKV_DMAX || D % 4 || tc <= 0)"):]
    assert tail in out


def test_edits_refuse_a_source_they_do_not_fit():
    with pytest.raises(ValueError):
        ws.variant_sources("// not the kernel\n")


def test_left_out_parts():
    v = ws.variant_sources()
    kernel_loop = v["kernel"][v["kernel"].index("  for (int c = 0; c < n_chunks"):]
    for call in ("chunk_factors<D, TW>(stage", "cross_scores<D, TW>(sm",
                 "inter_product<D, TW>(sm", "chunk_outputs<D, TW>(stage"):
        assert call in kernel_loop
    lo = v["loads_only"]
    loop = lo[lo.index("  for (int c = 0; c < n_chunks"):]
    assert "load_chunk<D, TW>" in loop and "chunk_factors<D, TW>(stage" \
        not in loop and "= 0u;" in loop
    assert "diag_scores<D, TW>(sm" not in v["no_intra"]
    assert "cross_scores<D, TW>(sm, warp" not in v["no_intra"]
    assert "diag_scores<D, TW>(sm" not in v["no_diag"]
    assert "cross_scores<D, TW>(sm, warp" in v["no_diag"]
    assert "inter_product<D, TW>(sm, st" not in v["no_inter"]
    assert "carry_state<D, TW>(sm, st" not in v["no_inter"]
    assert "chunk_factors<D, TW>(stage" not in v["no_factors"]
    for name in ("scalar", "scalar_loads_only", "scalar_arith_only"):
        assert "launch<__nv_bfloat16, float>" in v[name]
        assert "return launch_tc_bf16(" not in v[name]
    assert "fmaf(rr.x" not in v["scalar_loads_only"]
    assert "    if (t0 == 0)\n    for (int j = 0; j < n; ++j) {\n" \
        in v["scalar_arith_only"]


def test_turns_come_first_and_last():
    assert ws.TURNS == ("kernel", "scalar")
    assert set(ws.TURNS) <= set(ws.VARIANTS)


def test_split_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the split runs")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ws.main()


def test_module_imports_neither_jax_nor_the_reference():
    src = (ROOT / "benchmarks" / "wkv_split_torch.py").read_text()
    assert not re.search(r"^\s*(import|from)\s+(jax|jaxlib|repro|benchmarks"
                         r"\.common)(\.|\s|$)", src, re.MULTILINE)
    child = ("import json, sys; import benchmarks.wkv_split_torch; "
             "print(json.dumps(sorted(m for m in sys.modules if "
             "m.split('.')[0] in ('jax', 'jaxlib', 'ml_dtypes', 'repro'))))")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", child], capture_output=True,
                         text=True, env=env, timeout=300, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
