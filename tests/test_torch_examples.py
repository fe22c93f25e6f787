"""The port's examples (``examples/*_torch.py``): the serving, quickstart
and training examples run on the host when asked, and every one refuses to
start without its device."""
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


def test_quickstart_on_the_host():
    res = _run("quickstart_torch.py", "--device", "cpu")
    assert res.returncode == 0, res.stderr[-2000:]
    out = res.stdout
    assert "with IO                       L* = 8.6 us (Eq. 8)" in out
    assert "paged attention out shape (2, 4, 32), finite=True (on cpu)" in out
    assert out.rstrip().endswith("quickstart OK")


def test_train_100m_on_the_host_and_resume(tmp_path):
    argv = ("--device", "cpu", "--steps", "3", "--batch", "2", "--seq", "32",
            "--ckpt", str(tmp_path))
    res = _run("train_100m_torch.py", *argv)
    assert res.returncode == 0, res.stderr[-2000:]
    lines = res.stdout.splitlines()
    assert lines[0] == "model: 81.8M params (12L x 768d, vocab 8192)"
    assert any(ln.startswith("trained 3 steps, 0k tokens") and
               ln.endswith("on cpu)") for ln in lines)
    assert sorted(os.listdir(tmp_path)) == ["step_3"]
    again = _run("train_100m_torch.py", *argv)
    assert again.returncode == 0, again.stderr[-2000:]
    assert again.stdout.splitlines()[-1].startswith("nothing to do")


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
@pytest.mark.parametrize("script", ["serve_tiered_kv_torch.py",
                                    "kvstore_demo_torch.py",
                                    "quickstart_torch.py",
                                    "train_100m_torch.py"])
def test_examples_without_a_card_exit_non_zero(script):
    res = _run(script, timeout=120)
    assert res.returncode != 0
    assert "--device cpu" in res.stderr and res.stdout == ""
