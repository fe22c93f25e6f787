"""The port's examples (``examples/*_torch.py``): the serving example runs
on the host when asked, and both refuse to start without their device."""
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"))


def _run(script, *argv, timeout=300):
    return subprocess.run(
        [sys.executable, str(ROOT / "examples" / script), *argv],
        capture_output=True, text=True, env=ENV, cwd=str(ROOT),
        timeout=timeout)


def test_serve_tiered_kv_on_the_host():
    res = _run("serve_tiered_kv_torch.py", "--device", "cpu")
    assert res.returncode == 0, res.stderr[-2000:]
    lines = res.stdout.splitlines()
    assert lines[0].startswith("served 10 requests, 80 tokens in ")
    assert lines[0].endswith("on cpu)")
    assert "all pages released: True" in lines[1]
    assert [ln.split("P=")[1] for ln in lines[2:4]] == ["2", "3"]


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
@pytest.mark.parametrize("script", ["serve_tiered_kv_torch.py",
                                    "kvstore_demo_torch.py"])
def test_examples_without_a_card_exit_non_zero(script):
    res = _run(script, timeout=120)
    assert res.returncode != 0
    assert "--device cpu" in res.stderr and res.stdout == ""
