"""The port's fault tolerance (``repro_torch.train.ft``): the reference's
tests of the restartable loop and the straggler detector, ported."""
import numpy as np
import torch

from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.ft import RestartableLoop, StragglerDetector


def test_restartable_loop_recovers(tmp_path):
    """Inject a failure mid-run; the loop restores and finishes."""
    calls = {"n": 0}

    def step_fn(state, batch):
        calls["n"] += 1
        if calls["n"] == 5:
            raise RuntimeError("injected preemption")
        return state + 1, {"loss": float(state)}

    mgr = CheckpointManager(str(tmp_path), every=2)
    saved = {}

    def save_and_track(step, state, force=False):
        saved[step] = int(state)
        return CheckpointManager.maybe_save(mgr, step, torch.as_tensor(state),
                                            force)

    mgr.maybe_save = save_and_track  # type: ignore[method-assign]

    def data_iter(start):
        def gen():
            i = start
            while True:
                yield i
                i += 1
        return gen()

    def restore_fn(step):
        return torch.tensor(saved[step])

    loop = RestartableLoop(step_fn, mgr, data_iter, max_restarts=2)
    state, end = loop.run(torch.tensor(0), 8, restore_fn=restore_fn)
    assert end == 8
    assert int(state) == 8
    assert loop.restarts == 1


def test_restartable_loop_gives_up():
    """Past ``max_restarts``, or with nothing to restore, the failure is
    raised."""
    def step_fn(state, batch):
        raise RuntimeError("always")

    loop = RestartableLoop(step_fn, CheckpointManager("unused", every=0),
                           lambda s: iter(range(s, 100)), max_restarts=0)
    try:
        loop.run(0, 3, restore_fn=lambda s: 0)
    except RuntimeError as e:
        assert "always" in str(e)
    else:
        raise AssertionError("the loop swallowed the failure")


def test_straggler_detector():
    det = StragglerDetector(n_hosts=8, window=8, threshold=2.0, grace_steps=3)
    rng = np.random.default_rng(0)
    flagged: list[int] = []
    for step in range(12):
        times = rng.normal(1.0, 0.05, 8)
        times[3] = 3.5  # host 3 is consistently 3.5x slower
        flagged = det.observe(times)
    assert flagged == [3]

    det2 = StragglerDetector(n_hosts=8, grace_steps=3)
    for step in range(12):
        times = rng.normal(1.0, 0.05, 8)
        if step == 4:
            times[5] = 5.0  # one transient blip: must NOT flag
        assert 5 not in det2.observe(times)
