"""The backward of the port's blockwise attention (``layers.attention`` at
S > ``block_kv``, ``layers._FlashFn``) against ``jax.grad`` through the
reference's ``repro.models.layers.attention`` (its ``custom_vjp``
``_flash``, op by op) and against plain autograd through the port's own
forward loop; and remat on against remat off, bit for bit.

Tolerances, stated before the first run: float32 -- the largest
``|got - want|`` over a gradient within 1e-5 of its largest ``|want|``;
bfloat16 -- the ``FLASH_*`` bounds (``tests/_torch_kernel_cases.py``):
3e-2 absolute after dividing by the gradient's largest ``|want|`` (the
gradients are not of order one, as the outputs are), and
``FLASH_ROW_TOL`` (1e-2) on every row of dq, dk and dv relative to the
row -- save dq's rows at position 0 under a causal mask, held to the
absolute bound alone: that query sees one key, a softmax over one logit
has zero derivative, and both packages return the rounding noise of
``dp - delta`` there (``dq`` of that row is 0 in exact arithmetic, so no
relative bound applies).

Against plain autograd in bfloat16 the backward is fed the forward's float32
output as its residual: the reference's backward (and so the port's) keeps
``out`` in bfloat16 (the FlashAttention-2 discipline) and its
``delta = sum(do * out)`` then carries that rounding, which the exact
gradient does not.  A row of dq is a cancelling sum (``dp - delta``), so
that rounding moves some dq rows by more than ``FLASH_ROW_TOL`` relative
to themselves (``ROADMAP.md`` C25); the whole bfloat16 path is held there
on dk and dv row by row and on dq by the absolute bound."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as ref
from repro_torch.models import layers as port

from _torch_kernel_cases import FLASH_ROW_TOL, row_rel_err, tol
from _torch_model_cases import batch, carried, configs

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}

#: name -> (B, S, Hq, Hkv, D, causal, window, block_kv); every S > block_kv
CASES = {
    "causal-rep2": (2, 128, 4, 2, 32, True, None, 64),
    "window-rep4": (1, 128, 4, 1, 32, True, 48, 32),
    "padded-rep2": (2, 100, 4, 2, 16, True, None, 32),
    "padded-noncausal-rep4": (1, 96, 8, 2, 32, False, None, 64),
    "padded-window-rep2": (1, 75, 4, 2, 32, True, 20, 32),
}
F32_REL = 1e-5


def _inputs(case, dtype, seed=0):
    Bq, S, Hq, Hkv, D, *_ = CASES[case]
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32) for s in (
        (Bq, S, Hq, D), (Bq, S, Hkv, D), (Bq, S, Hkv, D), (Bq, S, Hq, D))]
    jd, td = DTYPES[dtype]
    return ([jnp.asarray(a, jd) for a in arrs[:3]], jnp.asarray(arrs[3]),
            [torch.from_numpy(a).to(td) for a in arrs[:3]],
            torch.from_numpy(arrs[3]))


def _kw(case):
    *_, causal, window, block_kv = CASES[case]
    return dict(causal=causal, sliding_window=window, block_kv=block_kv)


def _port_grads(fn, qkv, cot):
    leaves = [t.clone().requires_grad_() for t in qkv]
    out = fn(*leaves)
    return torch.autograd.grad((out.float() * cot).sum(), leaves)


def _check(got, want, dtype, causal):
    for name, g, w in zip("qkv", got, want):
        g, w = g.float(), w.float()
        assert g.shape == w.shape, name
        scale = float(w.abs().max())
        err = float((g - w).abs().max()) / scale
        if dtype == "float32":
            assert err <= F32_REL, (name, err)
        else:
            assert err <= tol(dtype), (name, err)
            if name == "q" and causal:      # position 0 sees one key
                g, w = g[:, 1:], w[:, 1:]
            assert row_rel_err(g, w) <= FLASH_ROW_TOL, (name,
                                                         row_rel_err(g, w))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_backward_against_jax_grad_of_the_reference(case, dtype):
    jq, jcot, tq, tcot = _inputs(case, dtype)
    kw = _kw(case)

    def ref_loss(q, k, v):
        out = ref.attention(q, k, v, **kw)
        return jnp.sum(out.astype(jnp.float32) * jcot)

    want = jax.grad(ref_loss, argnums=(0, 1, 2))(*jq)
    got = _port_grads(lambda q, k, v: port.attention(q, k, v, **kw), tq,
                      tcot)
    for g, w in zip(got, want):
        assert g.dtype == DTYPES[dtype][1]
    _check(got, [torch.from_numpy(np.asarray(jnp.asarray(w, jnp.float32)))
                 for w in want], dtype, kw["causal"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_backward_against_autograd_through_the_forward_loop(case, dtype):
    """The same gradients as autograd differentiating the blockwise
    forward loop itself (which saves every block's temporaries)."""
    *_, tq, tcot = _inputs(case, dtype, seed=1)
    kw = _kw(case)
    causal, win, bkv = kw["causal"], kw["sliding_window"] or 0, kw["block_kv"]
    want = _port_grads(lambda q, k, v: port._flash_fwd(
        q, k, v, causal, win, bkv)[0], tq, tcot)
    got = _port_grads(lambda q, k, v: port.attention(q, k, v, **kw), tq,
                      tcot)
    if dtype == "float32":
        _check(got, want, dtype, causal)
        return
    # the backward itself, fed the float32 output as its residual and the
    # cotangent as autograd passes it (in the output's dtype)
    out32, lse = port._flash_fwd(*(t.float() for t in tq), causal, win, bkv)
    alone = port._flash_bwd(*tq, out32, lse, tcot.to(tq[0].dtype), causal,
                            win, bkv)
    _check(alone, want, dtype, causal)
    # the whole path, bfloat16 residual: dk, dv every row; dq absolute
    for name, g, w in zip("qkv", got, want):
        g, w = g.float(), w.float()
        assert float((g - w).abs().max()) / float(w.abs().max()) <= tol(dtype)
        if name != "q":
            assert row_rel_err(g, w) <= FLASH_ROW_TOL, name


def test_forward_unchanged_and_only_out_and_lse_saved():
    """The custom function's output is the forward loop's, bit for bit, and
    the backward keeps q, k, v, ``out`` and the float32 ``lse``: nothing of
    S x S."""
    *_, tq, _ = _inputs("causal-rep2", "bfloat16")
    kw = _kw("causal-rep2")
    saved = []
    leaves = [t.clone().requires_grad_() for t in tq]
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append((tuple(t.shape), t.dtype)) or t,
            lambda t: t):
        out = port.attention(*leaves, **kw)
    plain, lse = port._flash_fwd(*tq, True, 0, kw["block_kv"])
    assert torch.equal(out, plain)
    Bq, S, Hq, Hkv, D = 2, 128, 4, 2, 32
    assert sorted(saved) == sorted([
        ((Bq, S, Hq, D), torch.bfloat16), ((Bq, S, Hkv, D), torch.bfloat16),
        ((Bq, S, Hkv, D), torch.bfloat16), ((Bq, S, Hq, D), torch.bfloat16),
        ((Bq, Hkv, Hq // Hkv, S), torch.float32)])
    assert lse.shape == (Bq, Hkv, Hq // Hkv, S) and lse.dtype == torch.float32


#: one arch of each family that checkpoints its own layers (the VLM runs
#: the dense transformer's)
REMAT_ARCHS = ["qwen2.5-3b", "deepseek-moe-16b", "rwkv6-3b", "zamba2-7b",
               "whisper-small"]


def _param_grads(arch, remat, **over):
    from repro_torch.tree import leaf_paths
    from repro_torch.zoo import get_api
    rcfg, cfg = configs(arch, **over)
    _, params = carried(rcfg)
    b = {k: torch.from_numpy(v) for k, v in batch(cfg, seq=96).items()}
    paths = leaf_paths(params)
    leaves = [p.detach().requires_grad_() for _, p in paths]
    from repro_torch.tree import set_leaf
    for (path, _), leaf in zip(paths, leaves):
        set_leaf(params, path, leaf)
    logits, aux = get_api(cfg).logits(params, b, cfg, remat=remat)
    loss = logits.float().logsumexp(-1).mean() + 0.01 * aux
    return torch.autograd.grad(loss, leaves, materialize_grads=True)


@pytest.mark.parametrize("arch", REMAT_ARCHS)
def test_remat_on_and_off_give_the_same_bits(arch):
    """Every parameter's gradient with per-layer recomputation equals the
    one without, bit for bit, at S 96 > the smoke ``attn_block_kv`` 64
    (the blockwise path in the attention families)."""
    on = _param_grads(arch, True)
    off = _param_grads(arch, False)
    for a, b in zip(on, off):
        assert torch.equal(a, b)


def test_two_level_remat_groups_give_the_same_bits():
    """``remat_groups = 2`` over the smoke config's 4 layers: the same
    gradients as per-layer remat and as none."""
    grouped = _param_grads("qwen2.5-3b", True, remat_groups=2)
    grouped_off = _param_grads("qwen2.5-3b", False, remat_groups=2)
    plain = _param_grads("qwen2.5-3b", False)
    for a, b, c in zip(grouped, grouped_off, plain):
        assert torch.equal(a, c) and torch.equal(b, c)


def test_layer_views_give_take_layers_gradients():
    """The forward's per-layer views come from one ``unbind`` a stacked
    leaf (its backward stacks the layers' gradients once); the gradients
    are those of one ``take_layer`` view a layer."""
    gen = torch.Generator().manual_seed(0)
    tree = {"w": torch.randn(4, 8, 8, generator=gen),
            "n": {"g": torch.randn(4, 8, generator=gen)}}
    x = torch.randn(3, 8, generator=gen)

    def loss(views):
        h = x
        for lw in views:
            h = torch.tanh(h @ lw["w"] * lw["n"]["g"])
        return h.square().sum()

    grads = []
    for make in (lambda t: port.layer_views(t, 4),
                 lambda t: [port.take_layer(t, i) for i in range(4)]):
        leaves = {"w": tree["w"].clone().requires_grad_(),
                  "n": {"g": tree["n"]["g"].clone().requires_grad_()}}
        grads.append(torch.autograd.grad(loss(make(leaves)),
                                         [leaves["w"], leaves["n"]["g"]]))
    for a, b in zip(*grads):
        assert torch.equal(a, b)
