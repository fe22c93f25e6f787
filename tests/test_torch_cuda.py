"""The port's CUDA kernels on a card -- the tests that need an NVIDIA GPU:
the scheduler kernels bit-equal to their plain versions, paged decode
attention within ``PAGED_TOL`` of its plain version, and a small serving
run through the paged kernel.

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
from repro_torch.kernels import ops as kops
from repro_torch.kernels import paged_kv_gather as pk
from repro_torch.kernels import sched_step as sk
from repro_torch.kernels import token_clock as tc
from repro_torch.kernels.ref import paged_decode_attention_ref

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


# -- paged decode attention ----------------------------------------------------

PAGED = {f"paged-{i}": c for i, c in enumerate(cases.PAGED_CASES)}
PAGED["edge-len1-full"] = cases.PAGED_EDGE
PAGED["serve-shape"] = cases.PAGED_SERVE


@pytest.mark.parametrize("n_buffers", [2, 3, 4])
@pytest.mark.parametrize("name", sorted(PAGED))
def test_paged_kernel_matches_plain_version(cuda, name, n_buffers):
    c = cases.make_paged_case(PAGED[name], seed=1)
    args = cases.paged_tensors(c, cuda)
    before = pk.paged_decode_attention.launches
    got = kops.paged_decode_attention(*args, n_buffers=n_buffers)
    want = paged_decode_attention_ref(*args)
    torch.cuda.synchronize()
    assert pk.paged_decode_attention.launches == before + 1
    assert got.dtype == want.dtype and got.shape == want.shape
    err = float((got.float() - want.float()).abs().max())
    assert err <= cases.PAGED_TOL[c["dtype"]], err


def test_paged_kernel_refuses_what_it_does_not_take(cuda):
    c = cases.make_paged_case(cases.PAGED_CASES[0], seed=2)
    q, k, v, bt, ln = cases.paged_tensors(c, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        pk.paged_decode_attention(q, k.transpose(1, 2).contiguous()
                                  .transpose(1, 2), v, bt, ln)
    with pytest.raises(ValueError, match="dtype"):
        pk.paged_decode_attention(q.half(), k.half(), v.half(), bt, ln)
    with pytest.raises(ValueError, match="shared memory"):
        big = torch.zeros(4, 256, 2, 64, device=cuda)
        pk.paged_decode_attention(q, big, big, bt, ln)


def test_serve_engine_on_the_card_agrees_with_the_dense_path(cuda):
    """A smoke-size engine on the card: every decode step goes through the
    kernel (n_layers launches a step), and its logits stay within
    ``MODEL_TOL`` of the dense path teacher-forced on the same tokens."""
    from repro_torch.configs import ARCHS, smoke_config
    from repro_torch.models import transformer as tf
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = smoke_config(ARCHS["qwen2.5-3b"]).replace(sliding_window=None)
    eng = ServeEngine(cfg, n_pages=32, page_size=8, max_slots=1, seed=0,
                      device=cuda)
    prompt = np.arange(1, 12, dtype=np.int32)
    req = Request(rid=0, prompt=prompt, max_new_tokens=6)
    eng.submit(req)
    before = pk.paged_decode_attention.launches
    paged = []
    while eng.waiting or eng.active:
        eng.step()
        paged.append(eng.last_decode[1][0].float())
    assert len(paged) == 5 and len(req.out_tokens) == 6
    assert pk.paged_decode_attention.launches - before == 5 * cfg.n_layers
    assert len(eng.cache.free) == 32
    _, cache = tf.prefill(eng.params, torch.from_numpy(prompt).to(cuda)[None],
                          cfg, max_len=len(prompt) + 6)
    for t in range(5):
        tok = torch.tensor([[req.out_tokens[t]]], device=cuda)
        logits, cache = tf.decode_step(eng.params, cache, tok, cfg)
        err = float((logits[0, 0].float() - paged[t]).abs().max())
        assert err <= cases.MODEL_TOL, (t, err)
