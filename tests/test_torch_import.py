"""The port stands alone: it imports ``torch`` and numpy, never ``jax``,
``jaxlib``, ``ml_dtypes`` or anything of the reference package ``repro`` --
not on import, not after a grid run, not after serving a request."""
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

_CHILD = r"""
import json, sys
import numpy as np
FOREIGN = ("jax", "jaxlib", "ml_dtypes", "repro")
def foreign():
    return sorted(m for m in sys.modules if m.split(".")[0] in FOREIGN)
import repro_torch
import repro_torch.core
import repro_torch.serve.engine
after_import = foreign()
from repro_torch.core.experiment import Experiment, RunOptions, Scenario
doc = json.load(open(sys.argv[1]))
doc.update(n_keys=1500, n_wl_ops=400, n_ops=100, latencies_us=[1, 5],
           thread_candidates=[4])
art = Experiment(Scenario.from_dict(doc), RunOptions(device="cpu")).run()
after_run = foreign()
from repro_torch.configs import ARCHS, smoke_config
from repro_torch.serve.engine import Request, ServeEngine
eng = ServeEngine(smoke_config(ARCHS["qwen2.5-3b"]), n_pages=16, page_size=8,
                  max_slots=2, device="cpu")
eng.submit(Request(rid=0, prompt=np.arange(1, 10, dtype=np.int32),
                   max_new_tokens=3))
served = eng.run()
print(json.dumps({"after_import": after_import, "after_run": after_run,
                  "after_serve": foreign(),
                  "rows": len(art.rows),
                  "thr": [r.throughput for r in art.rows],
                  "served": [len(r.out_tokens) for r in served]}))
"""


def test_import_and_run_leave_jax_and_reference_out_of_sys_modules():
    import json
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-c", _CHILD,
         str(ROOT / "examples" / "scenarios" / "hash_index_2ssd.json")],
        capture_output=True, text=True, env=env, timeout=300, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-2000:]
    doc = json.loads(out.stdout.strip().splitlines()[-1])
    assert doc["after_import"] == [] and doc["after_run"] == []
    assert doc["after_serve"] == []
    assert doc["rows"] == 2 and all(t > 0 for t in doc["thr"])
    assert doc["served"] == [3]


def _sources():
    files = sorted(PORT.rglob("*.py")) + sorted(PORT.rglob("*.cu")) \
        + sorted(PORT.rglob("*.cuh")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 25
    return files


@pytest.mark.parametrize("pattern,what", [
    (r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)", "imports"),
    (r"\b(jax|jnp|jaxlib)\b", "names"),
    (r"importlib\.import_module\(\s*[\"'](jax|repro)[\"'.]", "imports"),
])
def test_no_port_source_names_jax_or_imports_the_reference(pattern, what):
    rx = re.compile(pattern, re.MULTILINE)
    hits = []
    for path in _sources():
        for m in rx.finditer(path.read_text()):
            hits.append(f"{path.relative_to(ROOT)}: {m.group(0).strip()!r}")
    assert not hits, f"port source {what} jax / the reference: {hits[:10]}"


def test_default_device_is_cuda_and_raises_without_one():
    import torch

    from repro_torch.core.experiment import Experiment, RunOptions, Scenario
    from repro_torch.core.sim import SimConfig, sweep_latency
    from repro_torch.core.sim import replay_torch as rt

    assert RunOptions().device is None and RunOptions().backend == "torch"
    if torch.cuda.is_available():
        assert rt.resolve_device(None).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        rt.resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        rt.resolve_device("cuda")
    sc = Scenario(engine="hash-index", n_keys=1500, n_wl_ops=400, n_ops=50,
                  latencies_us=(1,), thread_candidates=(4,))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Experiment(sc).run()
    tr = Experiment(sc).build()
    from repro_torch.core.engines import run_trace
    trace = run_trace(*tr).trace
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sweep_latency(SimConfig(), trace, [1e-6], [4], n_ops=50)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rt.sweep_grid(SimConfig(), trace, [1e-6], [4], n_ops=50)
    assert rt.resolve_device("cpu").type == "cpu"
    from repro_torch.configs import ARCHS, smoke_config
    from repro_torch.serve.engine import ServeEngine
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(smoke_config(ARCHS["qwen2.5-3b"]), n_pages=8)


def test_cluster_scenarios_raise_not_implemented():
    from repro_torch.core.experiment import Experiment, RunOptions, Scenario
    sc = Scenario(engine="hash-index", n_keys=1500, n_wl_ops=400, n_ops=50,
                  latencies_us=(1,), thread_candidates=(4,),
                  cluster={"n_nodes": 2})
    assert Scenario.from_json(sc.to_json()) == sc     # the field round-trips
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Experiment(sc, RunOptions(device="cpu")).run()


def test_backends_and_fork_context():
    import multiprocessing as mp

    from repro_torch.core.sim import BACKENDS, SimConfig, sweep_latency
    from repro_torch.core.sim import sweep as sweep_mod

    assert BACKENDS == ("torch", "loop")
    with pytest.raises(ValueError, match="backend"):
        sweep_latency(SimConfig(), [], [1e-6], [4], backend="jax")
    # no CUDA context in this process -> the fast fork path is allowed
    import torch
    if not torch.cuda.is_initialized():
        ctx = sweep_mod._pick_context(object(), None)
        if "fork" in mp.get_all_start_methods():
            assert ctx.get_start_method() == "fork"
