"""``benchmarks/flash_split_torch.py``: every variant's edit still finds its
place in the kernel's source and changes it, the timed order, no card -> an
error, and a module that imports neither jax nor the reference package.
The timings themselves run on the card only."""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmarks import flash_split_torch as fs

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("name", sorted(fs.VARIANTS))
def test_every_variant_edits_the_current_source(name):
    src = (ROOT / "src" / "repro_torch" / "kernels" / "csrc"
           / "flash_attention.cu").read_text()
    out = fs.variant_sources(src)[name]
    assert (out == src) == (name == "kernel")
    # the scalar float32 instance is never touched
    head = src[src.index("template <typename T, int D>"):
               src.index("// -- wgmma_bf16")]
    assert head in out


def test_edits_refuse_a_source_they_do_not_fit():
    with pytest.raises(ValueError):
        fs.variant_sources("// not the kernel\n")


def test_left_out_parts():
    v = fs.variant_sources()
    assert "wgmma_ss_n128(sc, da, db" not in v["no_qk"]
    assert "wgmma_rs<D>(o, a," not in v["no_pv"]
    assert "ex2(fmaf(sc[i]" not in v["no_softmax"]
    lo = v["loads_only"]
    assert all(s not in lo for s in ("wgmma_ss_n128(sc, da, db",
                                     "wgmma_rs<D>(o, a,", "ex2(fmaf(sc[i]"))
    assert "wgmma_wait<1>()" in v["kernel"]
    assert "wgmma_wait<1>()" not in v["no_overlap"]
    assert "#define TC_STAGES 2\n" in v["two_stages"]
    assert "dim3 grid(B * Hq, (S + TC_BQ - 1) / TC_BQ)" in v["heads_fastest"]


def test_split_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the split runs")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fs.main()


def test_module_imports_neither_jax_nor_the_reference():
    src = (ROOT / "benchmarks" / "flash_split_torch.py").read_text()
    assert not re.search(r"^\s*(import|from)\s+(jax|jaxlib|repro|benchmarks"
                         r"\.common)(\.|\s|$)", src, re.MULTILINE)
    child = ("import json, sys; import benchmarks.flash_split_torch; "
             "print(json.dumps(sorted(m for m in sys.modules if "
             "m.split('.')[0] in ('jax', 'jaxlib', 'ml_dtypes', 'repro'))))")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", child], capture_output=True,
                         text=True, env=env, timeout=300, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
