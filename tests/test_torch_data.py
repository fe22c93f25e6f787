"""The port's data pipeline (``repro_torch.data.pipeline``): the
generators are the reference's numpy code, so the batches are the
reference's arrays bit for bit; ``prefetch`` keeps order and puts tensors
on the asked device."""
import numpy as np
import pytest
import torch

from repro.data import pipeline as ref
from repro_torch.data import pipeline as port


def _take(it, n):
    return [next(it) for _ in range(n)]


@pytest.mark.parametrize("host", [0, 1])
def test_synthetic_batches_equal_the_reference(host):
    kw = dict(global_batch=4, seq_len=24, vocab=512, seed=3, host_id=host,
              n_hosts=2)
    got = _take(port.synthetic_batches(port.DataConfig(**kw)), 4)
    want = _take(ref.synthetic_batches(ref.DataConfig(**kw)), 4)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w) == ["loss_mask", "targets", "tokens"]
        for k in g:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape
            assert g[k].tobytes() == w[k].tobytes()
        assert g["tokens"].shape == (2, 24)
    # resumable: step 2 onwards is the same from start_step=2
    again = _take(port.synthetic_batches(port.DataConfig(**kw), 2), 2)
    for g, w in zip(again, got[2:]):
        assert all(g[k].tobytes() == w[k].tobytes() for k in g)


def test_file_batches_equal_the_reference(tmp_path):
    path = tmp_path / "tokens.bin"
    np.random.default_rng(0).integers(0, 1000, 10_000).astype(
        np.int32).tofile(path)
    kw = dict(global_batch=6, seq_len=32, vocab=1000, seed=1, host_id=1,
              n_hosts=3)
    got = _take(port.file_batches(str(path), port.DataConfig(**kw), 5), 3)
    want = _take(ref.file_batches(str(path), ref.DataConfig(**kw), 5), 3)
    for g, w in zip(got, want):
        for k in ("tokens", "targets", "loss_mask"):
            assert g[k].dtype == w[k].dtype
            assert g[k].tobytes() == w[k].tobytes()
        assert np.array_equal(g["tokens"][:, 1:], g["targets"][:, :-1])


def test_prefetch_keeps_order_and_puts_tensors_on_the_device():
    cfg = port.DataConfig(global_batch=2, seq_len=8, vocab=64, seed=0)
    src = _take(port.synthetic_batches(cfg), 5)
    pulled = []

    def gen():
        for b in src:
            pulled.append(len(pulled))
            yield b

    it = port.prefetch(gen(), depth=3, device="cpu")
    first = next(it)
    # depth batches ahead, refilled before the first is handed out
    assert len(pulled) == 3 + 1
    out = [first] + list(it)
    assert len(out) == 5
    for b, w in zip(out, src):
        for k, v in b.items():
            assert torch.is_tensor(v) and v.device.type == "cpu"
            assert v.dtype == {np.int32: torch.int32,
                               np.float32: torch.float32}[w[k].dtype.type]
            assert np.array_equal(v.numpy(), w[k])


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_prefetch_defaults_to_the_card():
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port.prefetch(iter([]))
