"""The port's token-clock update against the reference's.

The plain PyTorch version (``repro_torch.kernels.token_clock``) is held
bit-equal to ``repro.kernels.token_clock.token_clock_update_ref`` and to the
reference's Pallas kernel run in interpret mode, on random ``(G, S)`` planes:
at S = 1, 2, 3, 8 and 64 (the CUDA kernel's specialised widths and its
generic path), with bool and integer masks (any non-zero entry selects its
device), empty rows and each clock disabled.  Contract: bit-exact (same
operations in the same order; a one-hot masked sum has one non-zero term, so
its order cannot matter).  On the CPU the port's
``token_clock_update`` wrapper takes the plain version; the CUDA kernel is
held against it on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental import enable_x64

from repro.kernels import token_clock as ref_tc
from repro_torch.kernels import token_clock as tc

from _torch_port_support import bits_equal


def _planes(seed, G, S, p_io=0.6):
    rng = np.random.default_rng(seed)
    submit = rng.random(G) * 1e-3
    dev = rng.integers(0, S, G)
    mask = (np.arange(S)[None, :] == dev[:, None]) \
        & (rng.random(G) < p_io)[:, None]
    return submit, mask, rng.random((G, S)) * 1e-3, rng.random((G, S)) * 1e-3


SPACINGS = [(1 / 250e3, 0.0), (1 / 250e3, 1024 / 400e6),
            (0.0, 1024 / 400e6), (0.0, 0.0)]


@pytest.mark.parametrize("G,S", [(1, 1), (7, 2), (64, 4), (33, 9)])
@pytest.mark.parametrize("inv_r,cost_bw", SPACINGS)
def test_plain_version_bit_equal_to_reference(G, S, inv_r, cost_bw):
    submit, mask, tok, bw = _planes(G * 31 + S, G, S)
    t = torch.from_numpy
    for fn in (tc.token_clock_update_ref, tc.token_clock_update):
        got = fn(t(submit), t(mask), t(tok), t(bw), inv_r, cost_bw)
        with enable_x64():
            want = ref_tc.token_clock_update_ref(
                jnp.asarray(submit), jnp.asarray(mask), jnp.asarray(tok),
                jnp.asarray(bw), inv_r, cost_bw)
            want = [np.asarray(w) for w in want]
        for a, b in zip(got, want):
            assert a.dtype == torch.float64
            assert bits_equal(a.numpy(), b)
    assert tc.token_clock_update.launches == 0      # CPU: no kernel launch


@pytest.mark.parametrize("inv_r,cost_bw", SPACINGS[:2])
def test_plain_version_bit_equal_to_interpreted_pallas_kernel(inv_r, cost_bw):
    submit, mask, tok, bw = _planes(3, 16, 2)
    t = torch.from_numpy
    got = tc.token_clock_update_ref(t(submit), t(mask), t(tok), t(bw), inv_r,
                                    cost_bw)
    with enable_x64():
        want = ref_tc.token_clock_update(
            jnp.asarray(submit), jnp.asarray(mask), jnp.asarray(tok),
            jnp.asarray(bw), inv_r, cost_bw, interpret=True)
        want = [np.asarray(w) for w in want]
    for a, b in zip(got, want):
        assert bits_equal(a.numpy(), b)


MASK_DTYPES = ("bool", "uint8", "int32", "int64")


def _reference(submit, mask, tok, bw, inv_r, cost_bw):
    with enable_x64():
        want = ref_tc.token_clock_update_ref(
            jnp.asarray(submit), jnp.asarray(mask != 0), jnp.asarray(tok),
            jnp.asarray(bw), inv_r, cost_bw)
        return [np.asarray(w) for w in want]


@pytest.mark.parametrize("S", [1, 2, 3, 8, 64])
@pytest.mark.parametrize("mask_dtype", MASK_DTYPES)
@pytest.mark.parametrize("inv_r,cost_bw", SPACINGS)
def test_plain_version_bit_equal_to_reference_at_every_width(
        S, mask_dtype, inv_r, cost_bw):
    """The widths and mask types the CUDA kernel's instances take; every
    fifth row empty besides the random ones; integer masks hold 3, not 1,
    where a device is selected."""
    G = 40
    submit, mask, tok, bw = _planes(S * 13 + len(mask_dtype), G, S)
    mask[::5] = False
    mask = mask.astype(mask_dtype) * (1 if mask_dtype == "bool" else 3)
    t = torch.from_numpy
    want = _reference(submit, mask, tok, bw, inv_r, cost_bw)
    for fn in (tc.token_clock_update_ref, tc.token_clock_update):
        got = fn(t(submit), t(mask), t(tok), t(bw), inv_r, cost_bw)
        for a, b in zip(got, want):
            assert a.dtype == torch.float64 and a.shape == b.shape
            assert bits_equal(a.numpy(), b)
    assert tc.token_clock_update.launches == 0      # CPU: no kernel launch


@pytest.mark.parametrize("S", [1, 2, 64])
def test_plain_version_with_no_io_this_step(S):
    """An all-empty mask: every service time is its submit time and every
    clock passes through."""
    submit, mask, tok, bw = _planes(S, 16, S)
    mask[:] = False
    t = torch.from_numpy
    got = tc.token_clock_update_ref(t(submit), t(mask), t(tok), t(bw),
                                    1 / 250e3, 1024 / 400e6)
    for a, b in zip(got, _reference(submit, mask, tok, bw, 1 / 250e3,
                                    1024 / 400e6)):
        assert bits_equal(a.numpy(), b)
    assert bits_equal(got[0].numpy(), submit)
    assert bits_equal(got[1].numpy(), tok) and bits_equal(got[2].numpy(), bw)


def test_token_clock_bench_needs_a_card():
    """The kernel's bench measures on the card and has no CPU fallback;
    its planes are the kernel's inputs."""
    from benchmarks import token_clock_bench_torch as tcb

    submit, mask, tok, bw = tcb.planes(7, 2, "cpu")
    assert (submit.shape, mask.shape, tok.shape, bw.shape) == (
        (7,), (7, 2), (7, 2), (7, 2))
    assert mask.dtype == torch.bool and int(mask.sum(1).max()) <= 1
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcb.main([])


def test_unit_grant_semantics():
    """The values of the reference's own unit test of the grant."""
    submit = torch.tensor([10.0, 20.0, 30.0], dtype=torch.float64)
    devmask = torch.tensor([[True, False], [False, True], [False, False]])
    tok = torch.tensor([[12.0, 0.0], [0.0, 19.0], [99.0, 99.0]],
                       dtype=torch.float64)
    bw = torch.zeros(3, 2, dtype=torch.float64)
    for fn in (tc.token_clock_update_ref, tc.token_clock_update):
        svc, tok2, bw2 = fn(submit, devmask, tok, bw, 0.5, 0.0)
        assert svc[0] == 12.0 and tok2[0, 0] == 12.5   # gated by clock
        assert svc[1] == 20.0 and tok2[1, 1] == 20.5   # clock behind
        assert svc[2] == 30.0                          # masked row:
        assert torch.all(tok2[2] == 99.0)              # clocks untouched
        assert torch.all(bw2 == 0.0)                   # disabled limit
    assert tok[0, 0] == 12.0                           # inputs not modified


def test_bandwidth_grant_sees_iops_delayed_service_time():
    submit = torch.tensor([1.0], dtype=torch.float64)
    mask = torch.tensor([[True]])
    tok = torch.tensor([[3.0]], dtype=torch.float64)
    bw = torch.tensor([[2.0]], dtype=torch.float64)
    svc, tok2, bw2 = tc.token_clock_update_ref(submit, mask, tok, bw, 0.5,
                                               0.25)
    assert svc[0] == 3.0 and tok2[0, 0] == 3.5 and bw2[0, 0] == 3.25
