"""The port's optimiser (``repro_torch.optim``) against the reference's
(``repro.optim``): the learning-rate schedules bit for bit at every step,
int8 gradient compression bit for bit, and one AdamW update bit for bit on
the same float32 and bfloat16 leaves.  The reference runs op by op (its
functions called outside ``jit``), which gives its IEEE bits; so does the
port on the CPU."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_support import given, settings, st

from repro.optim import adamw as ref_adamw
from repro.optim import grad_compress as ref_gc
from repro.optim import schedule as ref_sched
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.layers import map_tree
from repro_torch.optim import adamw, grad_compress, schedule
from repro_torch.optim.grad_compress import dequantize, ef_compress_grads, quantize
from repro_torch.optim.schedule import constant, warmup_cosine, warmup_rsqrt

from _torch_port_support import bits_equal


def test_schedules():
    assert float(warmup_cosine(0, 1e-3, 10, 100)) == 0.0
    assert float(warmup_cosine(10, 1e-3, 10, 100)) == pytest.approx(1e-3)
    assert float(warmup_cosine(100, 1e-3, 10, 100)) == pytest.approx(1e-4)
    assert float(warmup_rsqrt(40, 1e-3, 10)) == pytest.approx(5e-4)
    assert float(constant(5, 1e-3)) == pytest.approx(1e-3)


SCHEDULES = [
    ("warmup_rsqrt", (1e-3, 10), 500),
    ("constant", (1e-3, 20), 100),
    ("constant", (1e-3,), 10),
]

#: (peak_lr, warmup, total), each run over steps 0..total (+ 10 past it)
COSINE = [(3e-4, 200, 10000), (1e-3, 10, 120), (6e-4, 15, 300),
          (3e-4, 1, 6)]


@pytest.mark.parametrize("name,args,total", SCHEDULES,
                         ids=lambda v: str(v))
def test_schedule_bits_at_every_step(name, args, total):
    """Every step 0..total, as a Python int and as an int32 tensor: the
    reference's float32 value bit for bit."""
    steps = np.arange(total + 1, dtype=np.int32)
    want = np.asarray(getattr(ref_sched, name)(jnp.asarray(steps), *args))
    got = getattr(schedule, name)(torch.from_numpy(steps), *args).numpy()
    assert got.dtype == np.float32 and bits_equal(got, want)
    for s in (0, 1, total // 2, total):
        one = getattr(schedule, name)(s, *args)
        assert one.dtype == torch.float32 and one.shape == ()
        assert bits_equal(one.numpy(), want[s])


def _ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


@pytest.mark.parametrize("args", COSINE, ids=str)
def test_warmup_cosine_every_ulp_from_float32_cos(args):
    """``warmup_cosine`` at every step, every ulp accounted for: the cosine's
    argument is the reference's bits, float32 ``torch.cos`` and XLA's
    ``cos`` differ by at most one ulp at some arguments (``ROADMAP.md``
    C24), and the reference's own arithmetic fed the port's cosine gives
    the port's learning rate bit for bit.  Where the cosines agree, the
    rates do."""
    peak, warmup, total = args
    floor = 0.1
    steps = np.arange(total + 11, dtype=np.int32)
    got = warmup_cosine(torch.from_numpy(steps), *args).numpy()
    step = jnp.asarray(steps, jnp.float32)
    frac = jnp.clip((step - warmup) / jnp.maximum(total - warmup, 1), 0.0,
                    1.0)
    arg = np.asarray(jnp.pi * frac)
    assert bits_equal((np.float32(np.pi) * torch.from_numpy(np.array(
        frac))).numpy(), arg)
    cos_ref = np.asarray(jnp.cos(jnp.asarray(arg)))
    cos_port = torch.cos(torch.from_numpy(arg)).numpy()
    assert _ulps(cos_port, cos_ref).max() <= 1
    warm = peak * step / jnp.maximum(warmup, 1)
    lr_port_cos = np.asarray(jnp.where(step < warmup, warm, peak * (
        floor + (1 - floor) * 0.5 * (1 + jnp.asarray(cos_port)))))
    assert bits_equal(got, lr_port_cos)
    want = np.asarray(ref_sched.warmup_cosine(jnp.asarray(steps), *args))
    same = cos_port.view(np.int32) == cos_ref.view(np.int32)
    assert bits_equal(got[same], want[same])


class TestGradCompression:
    @settings(max_examples=25, deadline=None)
    @given(st.lists(st.floats(-100, 100, allow_nan=False), min_size=2,
                    max_size=64))
    def test_quantize_bound(self, xs):
        x = torch.tensor(xs, dtype=torch.float32)
        q, s = quantize(x)
        err = torch.abs(dequantize(q, s) - x)
        assert float(torch.max(err)) <= float(s) / 2 + 1e-6

    def test_error_feedback_preserves_sum(self):
        """EF invariant: dequantized + residual == grad + old residual."""
        g = {"w": torch.from_numpy(np.random.default_rng(0).normal(
            0, 1, (32, 8)).astype(np.float32))}
        e = {"w": torch.zeros((32, 8))}
        q, s, e2 = ef_compress_grads(g, e)
        back = dequantize(q["w"], s["w"])
        np.testing.assert_allclose(back + e2["w"], g["w"], atol=1e-5)

    def test_ef_converges_on_repeat(self):
        """Repeatedly compressing the same gradient transmits it in full."""
        g = torch.from_numpy(np.random.default_rng(1).normal(
            0, 1, (64,)).astype(np.float32))
        e = torch.zeros_like(g)
        sent = torch.zeros_like(g)
        for _ in range(8):
            q, s, e_new = ef_compress_grads({"g": g}, {"g": e})
            sent = sent + dequantize(q["g"], s["g"])
            e = e_new["g"]
        np.testing.assert_allclose(sent / 8, g, atol=0.02)


def _grad_tree(seed, dtypes=("float32", "bfloat16")):
    """Numpy leaves in an insertion order that is not sorted, with halves
    (x.5 * scale) to exercise round-half-to-even."""
    rng = np.random.default_rng(seed)
    tree = {"w": rng.normal(0, 3, (64, 96)), "b": rng.normal(0, 1, (16,)),
            "emb": {"z": rng.normal(0, 0.01, (8, 4)),
                    "a": np.array([0.5, 1.5, -2.5, 127.0]) / 127.0 * 3.0}}
    out = {}
    for i, (k, v) in enumerate(tree.items()):
        dt = jnp.dtype(dtypes[i % len(dtypes)])
        if isinstance(v, dict):
            out[k] = {kk: np.asarray(jnp.asarray(vv, dt))
                      for kk, vv in v.items()}
        else:
            out[k] = np.asarray(jnp.asarray(v, dt))
    return out


def test_quantize_and_ef_bit_equal_to_reference():
    g = _grad_tree(3)
    e = jax.tree.map(lambda a: np.asarray(
        jnp.asarray(np.random.default_rng(4).normal(0, 0.01, a.shape),
                    a.dtype)), g)
    q_r, s_r, e_r = ref_gc.ef_compress_grads(
        jax.tree.map(jnp.asarray, g), jax.tree.map(jnp.asarray, e))
    q_p, s_p, e_p = grad_compress.ef_compress_grads(
        params_from_numpy(g, "cpu"), params_from_numpy(e, "cpu"))
    for got, want in ((q_p, q_r), (s_p, s_r), (e_p, e_r)):
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            a = a.float().numpy() if a.dtype == torch.bfloat16 else a.numpy()
            b = np.asarray(jnp.asarray(b, jnp.float32)) \
                if b.dtype == jnp.bfloat16 else np.asarray(b)
            assert a.dtype == b.dtype and bits_equal(a, b)
    x = np.random.default_rng(5).normal(0, 2, (257,)).astype(np.float32)
    x[:4] = [0.5, -1.5, 2.5, 127.0]           # ties at scale 1 / 127 * 127
    q, s = quantize(torch.from_numpy(x))
    qr, sr = ref_gc.quantize(jnp.asarray(x))
    assert bits_equal(q.numpy(), np.asarray(qr))
    assert bits_equal(s.numpy(), np.asarray(sr))
    assert bits_equal(dequantize(q, s).numpy(),
                      np.asarray(ref_gc.dequantize(qr, sr)))


def _f32(x):
    x = x.float() if torch.is_tensor(x) else jnp.asarray(x, jnp.float32)
    return np.asarray(x)


def _adamw_both(params, grads, cfg_kw, moment, steps=2, lr=1e-3):
    """``steps`` AdamW updates on the same leaves in both packages; the
    same gradients each step."""
    rcfg = ref_adamw.AdamWConfig(moment_dtype=jnp.dtype(moment), **cfg_kw)
    pcfg = adamw.AdamWConfig(moment_dtype=getattr(torch, moment), **cfg_kw)
    rp = jax.tree.map(jnp.asarray, params)
    rg = jax.tree.map(jnp.asarray, grads)
    ro = ref_adamw.init_opt_state(rp, rcfg)
    pp = params_from_numpy(params, "cpu")
    po = adamw.init_opt_state(pp, pcfg)
    out = []
    for _ in range(steps):
        rp, ro, rm = ref_adamw.adamw_update(rp, rg, ro, jnp.float32(lr),
                                            rcfg)
        pp, po, pm = adamw.adamw_update(pp, params_from_numpy(grads, "cpu"),
                                        po, torch.tensor(lr), pcfg)
        # the update works in place: keep this step's leaves as they are
        out.append(((rp, ro, rm), (map_tree(lambda a: a, pp),
                                   map_tree(lambda a: a, po), pm)))
    return out


def _assert_state_bits(ref, port):
    (rp, ro, rm), (pp, po, pm) = ref, port
    from repro_torch.tree import leaves
    for a, b in zip(leaves(pp), jax.tree.leaves(rp)):
        assert str(a.dtype).split(".")[1] == str(b.dtype)
        assert bits_equal(_f32(a), _f32(b))
    for k in ("m", "v"):
        for a, b in zip(leaves(po[k]), jax.tree.leaves(ro[k])):
            assert bits_equal(_f32(a), _f32(b))
    assert int(po["count"]) == int(ro["count"])
    assert po["count"].dtype == torch.int32
    assert bits_equal(pm["lr"].numpy(), np.asarray(rm["lr"]))


@pytest.mark.parametrize("moment", ["float32", "bfloat16"])
def test_adamw_update_bit_equal_without_clipping(moment):
    """Gaussian leaves, float32 and bfloat16, two steps, ``grad_clip=0``:
    new params, m and v bit for bit.  ``grad_norm`` there sums each leaf's
    squares in the library's own order (XLA and PyTorch reduce a float32
    array in different orders, ``ROADMAP.md`` C23): within 1e-6 relative."""
    params, grads = _grad_tree(0), _grad_tree(1)
    for ref, port in _adamw_both(params, grads, dict(grad_clip=0.0), moment):
        _assert_state_bits(ref, port)
        np.testing.assert_allclose(port[2]["grad_norm"].numpy(),
                                   np.asarray(ref[2]["grad_norm"]),
                                   rtol=1e-6)


def test_adamw_update_bit_equal_with_clipping_and_sorted_order():
    """Gradients whose per-leaf sums of squares are exact in float32, so
    the in-leaf order cannot matter, while the leaf totals (2^24 in ``w``,
    last in sorted order, beside three sums below 1 that together pass 1)
    round differently when added in another order:
    ``grad_norm`` is the reference's bits only in sorted-key order, and
    with it the clip scale and every new leaf."""
    rng = np.random.default_rng(2)
    params = _grad_tree(0)
    grads = jax.tree.map(lambda a: rng.integers(-1, 2, a.shape) * 2.0 ** -8,
                         params)
    grads["w"][0, 0] = 4096.0            # a total of 2^24, last in order
    grads["b"][:2] = 0.5                 # 0.5 + ~0.002, first in order
    grads["emb"]["a"][:2] = [0.5, 0.25]  # 0.3125
    grads["emb"]["z"][0, 0] = 0.5        # 0.25 + ~0.0005
    grads = jax.tree.map(lambda a, p: np.asarray(jnp.asarray(a, p.dtype)),
                         grads, params)
    from repro_torch.tree import leaves
    pg = params_from_numpy(grads, "cpu")
    sq = [torch.sum(torch.square(x.float())) for x in leaves(pg)]
    insertion = [torch.sum(torch.square(x.float())) for x in
                 (pg["w"], pg["b"], pg["emb"]["z"], pg["emb"]["a"])]
    assert float(sum(sq)) != float(sum(insertion))   # the order matters
    steps = _adamw_both(params, grads, dict(grad_clip=1.0), "float32")
    for ref, port in steps:
        _assert_state_bits(ref, port)
        assert bits_equal(port[2]["grad_norm"].numpy(),
                          np.asarray(ref[2]["grad_norm"]))


def test_adamw_updates_in_place_and_frees_grads():
    """The caller's trees come back updated leaf by leaf (the reference's
    donated step), and the gradients are released as they are used."""
    params, grads = _grad_tree(0), _grad_tree(1)
    cfg = adamw.AdamWConfig()
    pp = params_from_numpy(params, "cpu")
    po = adamw.init_opt_state(pp, cfg)
    pg = params_from_numpy(grads, "cpu")
    kept, m_tree = pp["w"], po["m"]
    new_p, new_o, _ = adamw.adamw_update(pp, pg, po, 1e-3, cfg)
    assert new_p is pp and new_o["m"] is m_tree and pp["w"] is not kept
    assert pg["w"] is None and pg["emb"]["a"] is None
    assert int(new_o["count"]) == 1 and int(po["count"]) == 0
