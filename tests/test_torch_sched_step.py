"""The port's plain scheduler step (``repro_torch.kernels.sched_step``) held
against the reference's (``repro.kernels.sched_step``), step by step.

The reference body is compiled at XLA's optimisation level 0: at its default
level XLA-CPU contracts ``a*b+c`` into fused multiply-adds inside a compiled
step, which eager PyTorch (and the CUDA build, ``-fmad=false``) never does;
level 0 gives the same bits as running the reference op by op, at a fraction
of the time.  Both packages step the *same* state (built once, carried across as numpy
arrays) under the *same* ``(K, n_u, G)`` numpy uniforms.  Contract: every
state plane is bit-equal after every step; only the sojourn histogram is held
to "equal, or unit mass moved between adjacent bins, same row total" because
its bin index goes through ``log``.  The CUDA kernel itself cannot run
without a GPU; ``chip_smoke.py`` holds it against this plain version on the
card over the same flag sets.
"""
import zlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import enable_x64

from repro.kernels import sched_step as ref_sk
from repro_torch.core.sim import replay_torch as rt
from repro_torch.kernels import sched_step as sk

import _torch_kernel_cases as cases
from _torch_kernel_cases import FLAG_SETS, hist_equal_or_adjacent
from _torch_port_support import (
    ENGINES,
    US,
    XLA_NO_FMA,
    bits_equal,
    engine_trace,
)


def _run_both(case):
    """Step the reference and the port under the case's uniforms; assert the
    plane contract after every step.  Returns the port's final state."""
    st, us = case["static"], case["u"]
    t = torch.from_numpy
    sub_p = sk.make_substep(**st)
    s_p = rt.state_from_numpy(case["state"])
    args_p = (t(case["kd"]), t(case["se"]), t(case["arr"]),
              t(case["nthr_g"]), case["n_trace"], t(case["L_mem_g"]),
              t(case["warm_g"]), case["n_ops"], case["dyn"])
    with enable_x64():
        s_r = tuple(jnp.asarray(p) for p in case["state"])
        args_r = (jnp.asarray(case["kd"]), jnp.asarray(case["se"]),
                  jnp.asarray(case["arr"]), jnp.asarray(case["nthr_g"]),
                  jnp.int32(case["n_trace"]), jnp.asarray(case["L_mem_g"]),
                  jnp.asarray(case["warm_g"]), jnp.float64(case["n_ops"]),
                  tuple(jnp.float64(d) for d in case["dyn"]))
        sub_r = jax.jit(ref_sk.make_substep(**st)).lower(
            s_r, jnp.asarray(us[0]), *args_r).compile(
                compiler_options=XLA_NO_FMA)
        for k in range(us.shape[0]):
            s_r = sub_r(s_r, jnp.asarray(us[k]), *args_r)
            s_p = sub_p(s_p, t(us[k]), *args_p)
            ok, err, bad = cases.states_agree(
                tuple(np.asarray(p) for p in s_r), s_p, case["has_lat"])
            assert ok, f"step {k}: plane {bad} differs (max abs err {err})"
    return s_p


@pytest.fixture(scope="module")
def hash_trace():
    return engine_trace("hash-index").trace


@pytest.mark.parametrize("engine", ENGINES)
def test_step_bit_equal_per_engine(engine):
    """Every engine's suboperation mix, default 2-SSD device flags."""
    trace = engine_trace(engine).trace
    case = cases.make_case(trace, FLAG_SETS["rio+bio-2ssd"],
                           zlib.crc32(engine.encode()), n_steps=220)
    final = _run_both(case)
    assert int(final[1][:, 2].min()) > 0        # ops really completed


@pytest.mark.parametrize("name", sorted(FLAG_SETS))
def test_step_bit_equal_per_flag_set(hash_trace, name):
    case = cases.make_case(hash_trace, FLAG_SETS[name],
                           zlib.crc32(name.encode()), n_steps=260)
    final = _run_both(case)
    assert int(final[1][:, 3].max()) > 0        # the measured window opened
    if case["has_lat"]:
        assert final[-2].sum() > 0              # sojourns were recorded


@pytest.mark.parametrize("name", ["eps+rho+jitter", "2cores",
                                  "open-loop+pct+deadline"])
def test_straight_line_idle_skip_equals_branching_form(hash_trace, name):
    """The default straight-line idle skip against the form that branches
    on ``starved.any()`` (the reference's ``lax.cond``): bit-equal."""
    case = cases.make_case(hash_trace, FLAG_SETS[name],
                           zlib.crc32(name.encode()) + 1, n_steps=200)
    ref = cases.run_plain(case)
    got = cases.run_plain(case, eager_wmin=False)
    for a, b in zip(ref, got):
        assert bits_equal(a.numpy(), b.numpy())


def test_fused_steps_on_cpu_is_k_plain_steps(hash_trace):
    """On CPU tensors ``fused_steps`` is K applications of the plain body
    (and counts no kernel launch); blocks of K compose."""
    case = cases.make_case(hash_trace, FLAG_SETS["rio+bio-2ssd"], 5,
                           n_steps=24)
    before = sk.fused_steps.launches
    whole = cases.run_fused(case, "cpu")
    blocks = cases.run_fused(case, "cpu", block=8)
    plain = cases.run_plain(case)
    assert sk.fused_steps.launches == before
    for a, b, c in zip(whole, blocks, plain):
        assert bits_equal(a.numpy(), b.numpy())
        assert bits_equal(a.numpy(), c.numpy())


def test_states_agree_contract():
    """The comparison itself: a flipped bit is caught, a unit of histogram
    mass may move one bin, not two, and never change the row total."""
    h = np.zeros((2, 512))
    h[0, 10] = 3
    planes = (np.ones((2, 6)), np.ones((2, 7), np.int32), h, np.zeros(2))
    same = tuple(p.copy() for p in planes)
    assert cases.states_agree(planes, same, True)[0]
    moved = tuple(p.copy() for p in planes)
    moved[2][0, 10], moved[2][0, 11] = 2, 1
    assert cases.states_agree(planes, moved, True)[0]
    assert not cases.states_agree(planes, moved, False)[0]
    far = tuple(p.copy() for p in planes)
    far[2][0, 10], far[2][0, 12] = 2, 1
    assert not cases.states_agree(planes, far, True)[0]
    lost = tuple(p.copy() for p in planes)
    lost[2][0, 10] = 2
    assert not cases.states_agree(planes, lost, True)[0]
    bit = tuple(p.copy() for p in planes)
    bit[0][1, 2] = np.nextafter(1.0, 2.0)
    ok, err, bad = cases.states_agree(planes, bit, True)
    assert not ok and bad == 0 and 0 < err < 1e-15
    assert hist_equal_or_adjacent(h, moved[2])


def test_tag_helpers_match_reference():
    rng = np.random.default_rng(11)
    keys = np.concatenate([rng.random(200) * 10.0 ** rng.integers(-9, 3, 200),
                           [0.0, sk.EPOCH, 3 * sk.EPOCH, sk.BIG]])
    idx = rng.integers(0, 256, keys.size).astype(np.int32)
    assert sk.BIG == ref_sk.BIG and sk.EPOCH == ref_sk.EPOCH
    assert (sk.TAG_BITS, sk.SPAN_SHIFT) == (ref_sk.TAG_BITS,
                                            ref_sk.SPAN_SHIFT)
    with enable_x64():
        enc_r = ref_sk.tag_encode(jnp.asarray(keys), jnp.asarray(idx))
        tid_r = np.asarray(ref_sk.tag_tid(enc_r))
        val_r = np.asarray(ref_sk.tag_value(enc_r))
        starts = rng.integers(0, 1 << 20, 64).astype(np.float64)
        ends = starts + rng.integers(1, 40, 64)
        span_r = np.asarray(ref_sk.pack_span(jnp.asarray(starts),
                                             jnp.asarray(ends)))
        i_r, e_r = (np.asarray(x) for x in
                    ref_sk.unpack_span(jnp.asarray(span_r)))
        enc_r = np.asarray(enc_r)
    enc_p = sk.tag_encode(torch.from_numpy(keys), torch.from_numpy(idx))
    assert bits_equal(enc_r, enc_p.numpy())
    assert np.array_equal(tid_r, sk.tag_tid(enc_p).numpy())
    assert bits_equal(val_r, sk.tag_value(enc_p).numpy())
    span_p = sk.pack_span(torch.from_numpy(starts), torch.from_numpy(ends))
    assert bits_equal(span_r, span_p.numpy())
    i_p, e_p = sk.unpack_span(span_p)
    assert bits_equal(i_r, i_p.numpy()) and bits_equal(e_r, e_p.numpy())
    assert np.array_equal(i_p.numpy(), starts)


def test_kernel_wrapper_refuses_what_the_kernel_does_not_take(hash_trace):
    """Validation runs before any launch, so it is testable without a GPU:
    the wrapper raises on shapes / dtypes the kernel does not take."""
    case = cases.make_case(hash_trace, FLAG_SETS["plain"], 3, n_steps=4)
    sub = sk.make_substep(**case["static"])
    state, us, tail = cases.step_args(case)
    bad = list(state)
    bad[1] = bad[1].long()                      # ci must be int32
    with pytest.raises(ValueError, match="ci"):
        sk._launch(sub.flags, tuple(bad), us, *tail)
    with pytest.raises(ValueError, match="planes"):
        sk._launch(sub.flags, state[:-1], us, *tail)
    wide = torch.zeros(case["G"], 300, dtype=torch.float64)
    bad = list(state)
    bad[2] = bad[3] = wide
    with pytest.raises(ValueError, match="thread slots"):
        sk._launch(sub.flags, tuple(bad), us, *tail)
    bad = list(state)
    bad[4] = bad[4].transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        sk._launch(sub.flags, tuple(bad), us, *tail)
