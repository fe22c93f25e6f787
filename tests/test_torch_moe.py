"""The port's MoE layer (``repro_torch.models.moe``) against the reference's
(``repro.models.moe``) on identical bfloat16 input bits, with the
reference's parameters carried over: routing, ranks within an expert, the
keep mask, the expert FFN's output and the load-balance loss.  The whole
model through the zoo is in ``test_torch_zoo.py``.

Routing: the router's float32 products are summed in another order by each
package (largest probability difference seen: 2e-7), so a token whose k-th
and (k+1)-th probabilities lie within ``NEAR_TIE`` may route differently.
Such tokens are counted, not filtered: the count at these inputs is
``NEAR_TIES`` (none), and every other token must route identically.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as ref_moe
from repro_torch.models import moe
from repro_torch.models.layers import take_layer

from _torch_model_cases import MODEL_TOL, carried, configs, f32

NEAR_TIE = 1e-5
NEAR_TIES = 0

#: name -> (arch, config overrides): the smoke configs as they are (32
#: groups of two tokens), one group of 64 tokens at capacity factor 0.25
#: (C 8 against an average load of 16: tokens are dropped), and 12 experts
#: padded to 16 (four dead experts masked out of routing).
VARIANTS = {
    "deepseek": ("deepseek-moe-16b", {}),
    "qwen2-moe": ("qwen2-moe-a2.7b", {}),
    "deepseek-drops": ("deepseek-moe-16b",
                       {"moe_groups": 1, "capacity_factor": 0.25}),
    "qwen2-moe-dead-experts": ("qwen2-moe-a2.7b", {"n_experts": 12}),
}


def _ref_ranks(flat_e, E, C):
    """The reference's rank-within-expert lines (``moe.py:109-121``)."""
    G, n = flat_e.shape
    order = jnp.argsort(flat_e, axis=-1, stable=True)
    sorted_e = jnp.take_along_axis(flat_e, order, axis=-1)
    first = jax.vmap(lambda se: jnp.searchsorted(se, jnp.arange(E)))(sorted_e)
    rank_sorted = jnp.arange(n)[None] - jnp.take_along_axis(
        first, sorted_e, axis=-1)
    rank = jnp.zeros((G, n), jnp.int32).at[
        jnp.arange(G)[:, None], order].set(rank_sorted.astype(jnp.int32))
    return rank, rank < C


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def case(request):
    arch, over = VARIANTS[request.param]
    rcfg, cfg = configs(arch, **over)
    rp, pp = carried(rcfg)
    x = np.random.default_rng(3).standard_normal((2, 32, cfg.d_model))
    x = x.astype(np.float32)
    return (rcfg, cfg, jax.tree.map(lambda a: a[0], rp["layers"]),
            take_layer(pp["layers"], 0), jnp.asarray(x, jnp.bfloat16),
            torch.from_numpy(x).bfloat16())


def _ref_route(xr, lw, rcfg):
    """The reference's routing lines (``moe.py:85-98``)."""
    T = xr.shape[0] * xr.shape[1]
    G = ref_moe.n_groups(T, rcfg)
    E = ref_moe.padded_experts(rcfg)
    xt = xr.reshape(G, T // G, -1)
    logits = jnp.einsum("gtd,de->gte", xt.astype(jnp.float32), lw["router"])
    if E != rcfg.n_experts:
        logits = jnp.where(jnp.arange(E)[None, None] >= rcfg.n_experts,
                           -jnp.inf, logits)
    probs = jax.nn.softmax(logits, axis=-1)
    return probs, jax.lax.top_k(probs, rcfg.top_k)[1], G, E


def test_routing_ranks_and_keep_match_reference(case):
    rcfg, cfg, rlw, plw, xr, xp = case
    probs_r, idx_r, G, E = _ref_route(xr, rlw, rcfg)
    probs, gates, idx, aux = moe.route(xp.reshape(G, -1, cfg.d_model),
                                       plw["router"], cfg)
    idx_r = np.asarray(idx_r)
    assert float(np.abs(probs.numpy() - np.asarray(probs_r)).max()) < 1e-6
    srt = np.sort(np.asarray(probs_r), axis=-1)[..., ::-1]
    near = srt[..., cfg.top_k - 1] - srt[..., cfg.top_k] < NEAR_TIE
    differ = (idx.numpy() != idx_r).any(-1)
    assert int(near.sum()) == NEAR_TIES
    assert not (differ & ~near).any()
    assert (idx.numpy() < cfg.n_experts).all()
    np.testing.assert_allclose(gates.sum(-1).numpy(), 1.0, rtol=1e-6)
    C = moe.capacity(idx.shape[1], cfg)
    assert C == ref_moe.capacity(idx.shape[1], rcfg)
    flat = idx.reshape(G, -1)
    rank, keep, dest = moe.dispatch_slots(flat, E, C)
    rank_r, keep_r = _ref_ranks(jnp.asarray(idx_r.reshape(G, -1)), E, C)
    assert np.array_equal(rank.numpy(), np.asarray(rank_r))
    assert np.array_equal(keep.numpy(), np.asarray(keep_r))
    assert np.array_equal(dest.numpy(),
                          flat.numpy() * C + np.minimum(rank.numpy(), C - 1))


def test_moe_mlp_matches_reference(case):
    rcfg, cfg, rlw, plw, xr, xp = case
    want, aux_r = ref_moe.moe_mlp(xr, rlw, rcfg)
    got, aux = moe.moe_mlp(xp, plw, cfg)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(f32(got), f32(want), atol=MODEL_TOL, rtol=0)
    assert abs(float(aux) - float(aux_r)) < MODEL_TOL


def test_drops_happen_where_capacity_is_short(case):
    """The drop variant does drop tokens (its keep mask has zeros)."""
    rcfg, cfg, _, plw, _, xp = case
    G = moe.n_groups(64, cfg)
    _, _, idx, _ = moe.route(xp.reshape(G, -1, cfg.d_model), plw["router"],
                             cfg)
    C = moe.capacity(idx.shape[1], cfg)
    _, keep, _ = moe.dispatch_slots(idx.reshape(G, -1),
                                    moe.padded_experts(cfg), C)
    assert bool(keep.all()) == (cfg.capacity_factor >= 1.0)


def test_top_k_ties_go_to_the_lower_index():
    """Equal probabilities (a zero router): the lowest k live experts, as
    ``jax.lax.top_k`` picks them."""
    rcfg, cfg = configs("qwen2-moe-a2.7b", n_experts=12)
    E = moe.padded_experts(cfg)
    x = torch.ones((1, 4, cfg.d_model), dtype=torch.bfloat16)
    _, gates, idx, _ = moe.route(x, torch.zeros((cfg.d_model, E)), cfg)
    _, want = jax.lax.top_k(jnp.full((1, 4, E), 1.0 / 12).at[..., 12:].set(0),
                            cfg.top_k)
    assert np.array_equal(idx.numpy(), np.asarray(want))
    assert idx.tolist() == [[[0, 1]] * 4]
    assert torch.equal(gates, torch.full_like(gates, 0.5))
