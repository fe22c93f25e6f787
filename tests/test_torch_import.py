"""The port stands alone: it imports ``torch`` and numpy, never ``jax``,
``jaxlib``, ``ml_dtypes`` or anything of the reference package ``repro`` --
not on import (the kernel ops, the conformance harness and the port's
benches included), not after a grid run, not after a fleet run, not after
serving a request, not after a forward of every family of the model zoo,
not after a whole ``Trainer.fit`` (the distribution layer and the
launchers, ``repro_torch.distributed`` and ``repro_torch.launch``,
the dry run among them, included)."""
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
import repro_torch.kernels.ops
import repro_torch.core.conformance
import benchmarks.kernels_bench_torch
import benchmarks.cluster_bench_torch
import benchmarks.common_torch
import benchmarks.run_torch
import benchmarks.paper_figs_torch
import benchmarks.torch_grid_bench
import benchmarks.tail_latency_bench_torch
import benchmarks.token_clock_bench_torch
import repro_torch.optim.adamw, repro_torch.optim.schedule
import repro_torch.optim.grad_compress
import repro_torch.train.train_step, repro_torch.train.trainer
import repro_torch.train.checkpoint, repro_torch.train.ft
import repro_torch.data.pipeline, repro_torch.roofline.analysis
import repro_torch.distributed, repro_torch.distributed.sharding
import repro_torch.launch, repro_torch.launch.mesh, repro_torch.launch.train
import repro_torch.launch.specs, repro_torch.launch.dryrun
import repro_torch.launch.report, benchmarks.roofline_table_torch
import importlib.util
for example in ("kvstore_demo_torch", "serve_tiered_kv_torch",
                "quickstart_torch", "train_100m_torch"):
    spec = importlib.util.spec_from_file_location(
        example, f"examples/{example}.py")
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
after_import = foreign()
from repro_torch.core.experiment import Experiment, RunOptions, Scenario
doc = json.load(open(sys.argv[1]))
doc.update(n_keys=1500, n_wl_ops=400, n_ops=100, latencies_us=[1, 5],
           thread_candidates=[4])
art = Experiment(Scenario.from_dict(doc), RunOptions(device="cpu")).run()
fleet = dict(doc, n_ops=60, latencies_us=[2], cluster={"n_nodes": 2})
art_fleet = Experiment(Scenario.from_dict(fleet),
                       RunOptions(device="cpu")).run()
after_run = foreign()
from repro_torch.configs import ARCHS, smoke_config
from repro_torch.serve.engine import Request, ServeEngine
eng = ServeEngine(smoke_config(ARCHS["qwen2.5-3b"]), n_pages=16, page_size=8,
                  max_slots=2, device="cpu")
eng.submit(Request(rid=0, prompt=np.arange(1, 10, dtype=np.int32),
                   max_new_tokens=3))
served = eng.run()
after_serve = foreign()
import torch
import repro_torch.zoo
from repro_torch.models import whisper
from repro_torch.models.layers import init_params
families = {}
for arch in ("qwen2.5-3b", "deepseek-moe-16b", "llava-next-mistral-7b",
             "zamba2-7b", "rwkv6-3b", "whisper-small"):
    cfg = smoke_config(ARCHS[arch])
    api = repro_torch.zoo.get_api(cfg)
    p = init_params(api.param_specs(cfg), torch.Generator().manual_seed(0))
    b = {"tokens": torch.ones((1, 6), dtype=torch.int32)}
    if cfg.family == "vlm":
        b["patches"] = torch.zeros((1, cfg.n_patches, cfg.vision_dim))
    if cfg.family == "encdec":
        b["frames"] = torch.zeros((1, cfg.n_frames, cfg.d_model))
    logits, _ = api.logits(p, b, cfg)
    families[cfg.family] = list(logits.shape)
after_zoo = foreign()
import tempfile
from repro_torch.train.train_step import TrainHParams
from repro_torch.train.trainer import Trainer
with tempfile.TemporaryDirectory() as ckpt_dir:
    tr = Trainer(smoke_config(ARCHS["qwen2.5-3b"]),
                 TrainHParams(warmup=1, total_steps=3), ckpt_dir=ckpt_dir,
                 ckpt_every=2, device="cpu")
    tr.hp_global_batch, tr.hp_seq_len = 2, 16
    _, log = tr.fit(3)
print(json.dumps({"after_import": after_import, "after_run": after_run,
                  "after_serve": after_serve, "after_zoo": after_zoo,
                  "after_fit": foreign(), "fit_steps": len(log),
                  "families": families,
                  "rows": len(art.rows),
                  "fleet_nodes": len(art_fleet.rows[0].nodes),
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
    assert doc["after_serve"] == [] and doc["after_zoo"] == []
    assert doc["after_fit"] == [] and doc["fit_steps"] == 3
    assert sorted(doc["families"]) == ["dense", "encdec", "hybrid", "moe",
                                       "ssm", "vlm"]
    assert doc["families"]["vlm"][1] == 6 + 8
    assert doc["rows"] == 2 and all(t > 0 for t in doc["thr"])
    assert doc["fleet_nodes"] == 2
    assert doc["served"] == [3]


_CLI_CHILD = r"""
import json, runpy, sys
sys.argv = ["benchmarks.run_torch", "--list-engines"]
runpy.run_module("benchmarks.run_torch", run_name="__main__")
print(json.dumps(sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib", "repro"))))
"""


def test_run_torch_list_engines_leaves_jax_and_reference_out():
    import json
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _CLI_CHILD],
                         capture_output=True, text=True, env=env,
                         timeout=120, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-2000:]
    *names, foreign = out.stdout.strip().splitlines()
    assert "hash-index" in names and json.loads(foreign) == []


#: the entry points of the port outside ``src/repro_torch``
ENTRY_POINTS = [ROOT / "benchmarks" / f"{m}.py" for m in (
    "common_torch", "run_torch", "paper_figs_torch", "torch_grid_bench",
    "tail_latency_bench_torch", "kernels_bench_torch",
    "cluster_bench_torch", "roofline_table_torch",
    "token_clock_bench_torch")] + [
        ROOT / "examples" / f"{m}.py" for m in (
        "kvstore_demo_torch", "serve_tiered_kv_torch", "quickstart_torch",
        "train_100m_torch")]


@pytest.mark.parametrize("path", ENTRY_POINTS, ids=lambda p: p.name)
def test_entry_points_import_neither_jax_nor_the_reference(path):
    """Nor the reference's benchmark modules, which import it."""
    rx = re.compile(
        r"^\s*(import|from)\s+((jax|jaxlib|repro)(\.|\s|$)|"
        r"\.(common|paper_figs|kernels_bench|cluster_bench|roofline_table|"
        r"run|jax_grid_bench|tail_latency_bench)\s|"
        r"benchmarks\.(common|paper_figs|kernels_bench|cluster_bench|"
        r"roofline_table|run|jax_grid_bench|tail_latency_bench)(\s|$)|"
        r"(\.|benchmarks)\s+import\s+(\w+(\s+as\s+\w+)?\s*,\s*)*"
        r"(common|paper_figs|kernels_bench|cluster_bench|roofline_table|run|"
        r"jax_grid_bench|tail_latency_bench)(\s+as\s+\w+)?\s*(,|$))",
        re.MULTILINE)
    assert not [m.group(0).strip() for m in rx.finditer(path.read_text())]


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
    from repro_torch.data.pipeline import prefetch
    from repro_torch.train.trainer import Trainer
    from repro_torch.train.train_step import TrainHParams
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(smoke_config(ARCHS["qwen2.5-3b"]), TrainHParams())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        prefetch(iter([]))


def test_cluster_scenarios_raise_not_implemented():
    """Fleets are ported now: a cluster scenario no longer raises
    ``NotImplementedError`` -- it runs, on the card by default (and raises
    there without one), and a malformed fleet is refused when the scenario
    is built, as in the reference."""
    import torch

    from repro_torch.core.cluster import ClusterSpec
    from repro_torch.core.experiment import Experiment, RunOptions, Scenario
    sc = Scenario(engine="hash-index", n_keys=1500, n_wl_ops=400, n_ops=50,
                  latencies_us=(1,), thread_candidates=(4,),
                  cluster={"n_nodes": 2})
    assert Scenario.from_json(sc.to_json()) == sc     # the field round-trips
    assert sc.cluster_spec() == ClusterSpec(n_nodes=2)
    art = Experiment(sc, RunOptions(backend="loop")).run()
    assert [n["node"] for n in art.rows[0].nodes] == [0, 1]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Experiment(sc).run()
    with pytest.raises(ValueError, match="replication"):
        Scenario(engine="hash-index", cluster={"n_nodes": 2,
                                               "replication": 3})


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
