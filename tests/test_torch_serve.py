"""Serving on the port: ``repro_torch.serve`` (paged KV cache + continuous
batching) against the reference's ``repro.serve`` on the CPU, with the
reference's parameters (``init_params`` from ``PRNGKey(0)``) carried over bit
for bit.  The reference engine's paged attention runs the Pallas kernel in
interpret mode, as its own tests run it.

Tolerance of the engine comparison: ``MODEL_TOL`` of
``tests/_torch_kernel_cases.py`` (0.125 absolute on bfloat16 logits; the
reason is given there).  Both engines are fed the reference's tokens
(teacher forcing), so every step compares the same computation; the port's
own greedy token must equal the reference's wherever the reference's top-1
minus top-2 logit margin exceeds twice that tolerance (a smaller margin may
flip under a difference the tolerance allows).
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import smoke_config as ref_smoke_config
from repro.core.tiering import CXL_MICROSECOND as REF_CXL
from repro.models import transformer as ref_tf
from repro.models.layers import init_params as ref_init_params
from repro.serve.engine import Request as RefRequest
from repro.serve.engine import ServeEngine as RefEngine
from repro.serve.kv_cache import PagedKVCache as RefCache
from repro.serve.kv_cache import PageStoreConfig as RefStoreConfig
from repro_torch.configs import ARCHS, smoke_config
from repro_torch.core.tiering import CXL_MICROSECOND
from repro_torch.models import transformer as tf
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.kv_cache import PagedKVCache, PageStoreConfig

from _torch_kernel_cases import MODEL_TOL


def f32(x):
    if torch.is_tensor(x):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.fixture(scope="module")
def small_model():
    rcfg = ref_smoke_config(REF_ARCHS["qwen2.5-3b"]).replace(
        sliding_window=None)
    cfg = smoke_config(ARCHS["qwen2.5-3b"]).replace(sliding_window=None)
    rp = ref_init_params(ref_tf.param_specs(rcfg), jax.random.PRNGKey(0))
    return rcfg, cfg, rp, params_from_numpy(jax.tree.map(np.asarray, rp))


class TestPagedKVCache:
    def _cache(self, n_pages=32, page=8, **kw):
        return PagedKVCache(PageStoreConfig(
            n_pages=n_pages, page_size=page, n_kv_heads=2, head_dim=16,
            n_layers=2, device="cpu", **kw))

    def test_admit_extend_release(self):
        c = self._cache()
        assert c.admit(1, 20)       # 3 pages
        assert len(c.tables[1]) == 3
        assert c.extend(1, 5)       # 25 tokens -> 4 pages
        assert len(c.tables[1]) == 4
        c.release(1)
        assert len(c.free) == 32

    def test_admission_control(self):
        c = self._cache(n_pages=4)
        assert c.admit(1, 30)       # 4 pages: all of them
        assert not c.admit(2, 1)    # no pages left
        c.release(1)
        assert c.admit(2, 1)

    @pytest.mark.parametrize("seed", range(10))
    def test_free_list_and_tables_match_reference(self, seed):
        """Seeded admit/extend/release sequences: the port's free list and
        block tables equal the reference's after every operation, and pages
        are conserved."""
        rng = np.random.default_rng(seed)
        c = self._cache(n_pages=64)
        r = RefCache(RefStoreConfig(n_pages=64, page_size=8, n_kv_heads=2,
                                    head_dim=16, n_layers=2))
        live = []
        for i in range(int(rng.integers(1, 16))):
            op = rng.integers(0, 3)
            if op == 0 or not live:
                plen = int(rng.integers(1, 41))
                assert c.admit(i, plen) == r.admit(i, plen)
                if i in c.tables:
                    live.append(i)
            elif op == 1:
                s, n = live[int(rng.integers(len(live)))], int(rng.integers(0, 31))
                assert c.extend(s, n) == r.extend(s, n)
            else:
                s = live.pop(int(rng.integers(len(live))))
                c.release(s)
                r.release(s)
            assert c.free == r.free and c.tables == r.tables
            assert c.lengths == r.lengths
            assert sum(len(t) for t in c.tables.values()) + len(c.free) == 64
        for s in live:
            c.release(s)
        assert len(c.free) == 64

    def test_page_io_and_views_match_reference(self):
        rng = np.random.default_rng(3)
        c = self._cache(dtype=torch.float32)
        r = RefCache(RefStoreConfig(n_pages=32, page_size=8, n_kv_heads=2,
                                    head_dim=16, n_layers=2,
                                    dtype=jnp.float32))
        for sid, plen in ((0, 13), (1, 8), (2, 21)):
            assert c.admit(sid, plen) and r.admit(sid, plen)
            k, v = (rng.standard_normal((2, plen, 2, 16)).astype(np.float32)
                    for _ in range(2))
            c.write_prompt(sid, torch.from_numpy(k), torch.from_numpy(v))
            r.write_prompt(sid, jnp.asarray(k), jnp.asarray(v))
        c.extend(0, 1)
        r.extend(0, 1)
        kt = rng.standard_normal((2, 2, 16)).astype(np.float32)
        c.append_token(0, torch.from_numpy(kt), torch.from_numpy(kt))
        r.append_token(0, jnp.asarray(kt), jnp.asarray(kt))
        assert np.array_equal(c.k_pages.numpy(), np.asarray(r.k_pages))
        assert np.array_equal(c.v_pages.numpy(), np.asarray(r.v_pages))
        bt, ln = c.batch_views([2, 0])
        rbt, rln = r.batch_views([2, 0])
        assert bt.dtype == torch.int32 and ln.dtype == torch.int32
        assert np.array_equal(bt.numpy(), np.asarray(rbt))
        assert np.array_equal(ln.numpy(), np.asarray(rln))
        page_idx, slot = c.token_slots([2, 0])
        assert page_idx.tolist() == [c.tables[2][20 // 8], c.tables[0][13 // 8]]
        assert slot.tolist() == [20 % 8, 13 % 8]

    def test_plan_prefetch_depth_matches_reference(self):
        for tier, rtier in ((None, None), (CXL_MICROSECOND, REF_CXL)):
            kw = {} if tier is None else dict(tier=tier)
            rkw = {} if rtier is None else dict(tier=rtier)
            c = self._cache(**kw)
            r = RefCache(RefStoreConfig(n_pages=32, page_size=8, n_kv_heads=2,
                                        head_dim=16, n_layers=2, **rkw))
            c.admit(0, 60)
            r.admit(0, 60)
            for t_page, t_other in ((2e-6, 20e-6), (0.5e-6, 2e-6)):
                assert c.plan_prefetch_depth(t_page, t_other) == \
                    r.plan_prefetch_depth(t_page, t_other)
        fast = self._cache()
        fast.admit(0, 60)
        slow = self._cache(tier=CXL_MICROSECOND)
        slow.admit(0, 60)
        assert slow.plan_prefetch_depth(2e-6, 20e-6) >= \
            fast.plan_prefetch_depth(2e-6, 20e-6) >= 1


def _drive(eng, forced=None):
    """Run ``eng`` to the end, recording the logits of every ``_sample``
    call and the page tables / free list after every step.  With
    ``forced``, the engine is fed those tokens instead of its own."""
    log, snaps = [], []
    own = eng._sample

    def sample(logits):
        log.append(f32(logits))
        if forced is None:
            return own(logits)
        return forced[len(log) - 1]

    eng._sample = sample
    while eng.waiting or eng.active:
        eng.step()
        snaps.append((copy.deepcopy(eng.cache.tables), list(eng.cache.free),
                      dict(eng.cache.lengths)))
    return log, snaps


def _requests(cls, vocab):
    rng = np.random.default_rng(11)
    # three prompts through two slots: the third is admitted mid-run
    return [cls(rid=i, prompt=rng.integers(1, vocab, n).astype(np.int32),
                max_new_tokens=m) for i, (n, m) in enumerate(((5, 5), (12, 4),
                                                               (9, 5)))]


def test_engine_matches_reference_engine(small_model):
    rcfg, cfg, rp, pp = small_model
    ref_eng = RefEngine(rcfg, rp, n_pages=12, page_size=8, max_slots=2)
    eng = ServeEngine(cfg, pp, n_pages=12, page_size=8, max_slots=2,
                      device="cpu")
    ref_reqs, reqs = _requests(RefRequest, cfg.vocab), _requests(Request,
                                                                 cfg.vocab)
    for a, b in zip(ref_reqs, reqs):
        ref_eng.submit(a)
        eng.submit(b)
    ref_log, ref_snaps = _drive(ref_eng)
    ref_tokens = [np.argmax(lg, axis=-1).reshape(-1) for lg in ref_log]
    log, snaps = _drive(eng, forced=ref_tokens)
    assert len(log) == len(ref_log) and snaps == ref_snaps
    checked = 0
    for i, (got, want) in enumerate(zip(log, ref_log)):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=MODEL_TOL, rtol=0,
                                   err_msg=f"sample call {i}")
        top2 = np.sort(want, axis=-1)[:, -2:]
        sure = top2[:, 1] - top2[:, 0] > 2 * MODEL_TOL
        assert np.array_equal(np.argmax(got, -1)[sure],
                              np.argmax(want, -1)[sure]), f"call {i}"
        checked += int(sure.sum())
    assert checked > 0
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in ref_reqs]
    assert len(eng.cache.free) == 12
    assert eng.stats["decode_steps"] == len(log) - 3    # 3 prefill samples
    assert eng.stats["prefill_tokens"] == 5 + 12 + 9


class TestEngineCorrectness:
    def test_paged_equals_dense_decode(self, small_model):
        """The engine's paged decode path must produce the same tokens as
        the plain full-cache decode path (greedy)."""
        _, cfg, _, params = small_model
        prompt = np.arange(1, 9, dtype=np.int32)
        n_new = 6

        logits, cache = tf.prefill(params, torch.from_numpy(prompt)[None],
                                   cfg, max_len=len(prompt) + n_new + 1)
        ref_tokens = [int(torch.argmax(logits[0, -1]))]
        for _ in range(n_new - 1):
            lg, cache = tf.decode_step(
                params, cache, torch.tensor([[ref_tokens[-1]]]), cfg)
            ref_tokens.append(int(torch.argmax(lg[0, -1])))

        eng = ServeEngine(cfg, params, n_pages=64, page_size=8, max_slots=2,
                          device="cpu")
        req = Request(rid=0, prompt=prompt, max_new_tokens=n_new)
        eng.submit(req)
        done = eng.run(max_steps=50)
        assert done and done[0].out_tokens == ref_tokens

    def test_continuous_batching(self, small_model):
        _, cfg, _, params = small_model
        eng = ServeEngine(cfg, params, n_pages=64, page_size=8, max_slots=2,
                          device="cpu")
        rng = np.random.default_rng(0)
        reqs = [Request(rid=i, prompt=rng.integers(1, cfg.vocab, 6).astype(np.int32),
                        max_new_tokens=4) for i in range(5)]
        for r in reqs:
            eng.submit(r)
        done = eng.run(max_steps=200)
        assert len(done) == 5
        assert all(len(r.out_tokens) == 4 for r in done)
        assert len(eng.cache.free) == eng.cache.cfg.n_pages  # all released

    def test_page_utilization_reporting(self, small_model):
        _, cfg, _, params = small_model
        eng = ServeEngine(cfg, params, n_pages=16, page_size=8, max_slots=4,
                          device="cpu")
        eng.submit(Request(rid=0, prompt=np.arange(1, 17, dtype=np.int32),
                           max_new_tokens=8))
        eng.step()  # request still active -> pages held
        assert 0 < eng.cache.utilization <= 1
        eng.run(max_steps=50)
        assert eng.cache.utilization == 0.0


def test_sampling_draws_from_an_explicit_generator(small_model):
    _, cfg, _, params = small_model

    def tokens(seed):
        eng = ServeEngine(cfg, params, n_pages=16, page_size=8, max_slots=1,
                          seed=seed, greedy=False, device="cpu")
        eng.submit(Request(rid=0, prompt=np.arange(1, 7, dtype=np.int32),
                           max_new_tokens=6))
        return eng.run()[0].out_tokens

    assert tokens(3) == tokens(3)
    assert all(0 <= t < cfg.vocab for t in tokens(4))


def test_engine_defaults_to_the_card():
    cfg = smoke_config(ARCHS["qwen2.5-3b"])
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PagedKVCache(PageStoreConfig(n_pages=4))
    eng = ServeEngine(cfg, n_pages=8, page_size=8, device="cpu")
    assert eng.params["embed"].device.type == "cpu"
    assert eng.params["embed"].dtype == torch.bfloat16
