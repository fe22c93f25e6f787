"""The port's CUDA kernels on a card -- the tests that need an NVIDIA GPU.

They import the port only (no jax), so they run on the GPU machine with::

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Without a CUDA device every test here skips.  ``chip_smoke.py`` runs the same
comparisons as part of its own checks.
"""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.engines import run_trace
from repro_torch.core.experiment import Experiment, Scenario
from repro_torch.core.sim import SimConfig
from repro_torch.core.sim import replay_torch as rt
from repro_torch.kernels import sched_step as sk
from repro_torch.kernels import token_clock as tc

import _torch_kernel_cases as cases

pytestmark = pytest.mark.requires_cuda

US = 1e-6


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def small_trace():
    doc = json.loads((Path(__file__).resolve().parents[1] / "examples"
                      / "scenarios" / "hash_index_2ssd.json").read_text())
    doc.update(n_keys=2000, n_wl_ops=600)
    sc = Scenario.from_dict(doc)
    store, wl = Experiment(sc).build()
    return run_trace(store, wl, warmup_frac=sc.warmup_frac).trace


@pytest.mark.parametrize("name", sorted(cases.FLAG_SETS))
def test_fused_kernel_matches_plain_version(cuda, small_trace, name):
    """Bit-equal planes (histogram: adjacent-bin rule) after 192 steps."""
    case = cases.make_case(small_trace, cases.FLAG_SETS[name], 17,
                           n_steps=192)
    before = sk.fused_steps.launches
    plain = cases.run_plain(case, cuda)
    fused = cases.run_fused(case, cuda)
    torch.cuda.synchronize()
    assert sk.fused_steps.launches == before + 1
    ok, err, bad = cases.states_agree(plain, fused, case["has_lat"])
    assert ok, f"{name}: plane {bad} differs (max abs err {err})"


def test_token_clock_kernel_matches_plain_version(cuda):
    rng = np.random.default_rng(5)
    G, S = 300, 3

    def t(a):
        return torch.from_numpy(a).to(cuda)

    submit = t(rng.random(G))
    mask = t((np.arange(S)[None, :] == rng.integers(0, S, G)[:, None])
             & (rng.random(G) < 0.7)[:, None])
    tok, bw = t(rng.random((G, S))), t(rng.random((G, S)))
    before = tc.token_clock_update.launches
    for inv_r, cost in ((0.5, 0.0), (0.5, 0.25), (0.0, 0.25), (0.0, 0.0)):
        got = tc.token_clock_update(submit, mask, tok, bw, inv_r, cost)
        want = tc.token_clock_update_ref(submit, mask, tok, bw, inv_r, cost)
        for a, b in zip(got, want):
            assert torch.equal(a.view(torch.int64), b.view(torch.int64))
    assert tc.token_clock_update.launches == before + 4


def test_grid_kernel_path_bit_identical_to_plain_path(cuda, small_trace):
    """The whole grid: fused kernel vs plain step on the card, same draws."""
    cfg = SimConfig(P=12, seed=7, n_ssd=2, R_io=250e3, L_switch=0.3 * US)
    kw = dict(n_ops=150, device=cuda)
    fused = rt.sweep_grid(cfg, small_trace, [1 * US, 5 * US], [4, 8], **kw)
    plain = rt.sweep_grid(cfg, small_trace, [1 * US, 5 * US], [4, 8],
                          use_kernel=False, **kw)
    for fld in ("throughput", "time", "mem_stall_total", "mem_accesses"):
        assert np.array_equal(getattr(fused, fld), getattr(plain, fld)), fld
    cpu = rt.sweep_grid(cfg, small_trace, [1 * US, 5 * US], [4, 8],
                        n_ops=150, device="cpu")
    assert np.array_equal(fused.throughput, cpu.throughput)
