"""The port's dry run (``repro_torch.launch.specs`` / ``.dryrun`` /
``.report``, ``repro_torch.roofline.analysis``, ``benchmarks/
roofline_table_torch.py``) against the reference's.

  * ``TestDryRunMachinery``: the reference's ``tests/test_system.py`` class
    of that name, case for case, on the port (the H100's constants in the
    roofline arithmetic, the counter's records in place of HLO text);
  * ``batch_specs`` shapes and dtypes equal to the reference's for all 40
    cells; ``default_microbatches`` equal for every arch on both production
    meshes under all four policies;
  * ``_link_factor``, ``collective_bytes`` and ``RooflineTerms``' arithmetic
    equal to the reference's with the constants swapped;
  * ``report``'s tables and the roofline table's rows byte-identical on the
    same rows;
  * one cell counted: the smoke qwen2.5-3b ``train_4k`` on a 2x2 mesh,
    lowered as the reference's fit variant (2 layers, one microbatch,
    unrolled) on an Auto-axis ``Mesh`` of 4 XLA host devices in a
    subprocess (the reference's own dry run dies on its Explicit-axis mesh,
    ROADMAP C27), counted by the port on a fake group of 4 ranks in another:
    the port's per-device matmul FLOPs within ``FLOPS_TOL`` of the dot
    FLOPs parsed from the reference's compiled HLO, once the one blockwise
    ``Q K^T`` per KV block that XLA's CSE shares between the remat forward
    and the backward is added back (``prevent_cse=False``; the port
    recomputes it); the argument bytes a device equal to the reference's
    ``argument_size_in_bytes``; and the port's ``_fit_metrics`` equal to
    its full count at that cell.
"""
import contextlib
import io
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from repro_torch.configs import (ARCHS, SHAPES, get_config, list_archs,
                                 shape_applicable)
from repro_torch.launch import report
from repro_torch.launch.specs import batch_specs, default_microbatches
from repro_torch.roofline import analysis
from repro_torch.roofline.analysis import (RooflineTerms, collective_bytes,
                                           dot_bytes, model_flops)

ROOT = Path(__file__).resolve().parents[1]
#: the port's matmul FLOPs against the reference's parsed dot FLOPs (the
#: count is exact once the shared Q K^T is added back; 2 % is the bound)
FLOPS_TOL = 0.02
#: the subprocesses' own timeout, s
TIMEOUT = 240


class FakeMesh:
    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


MESHES = {"single": {"data": 16, "model": 16},
          "multi": {"pod": 2, "data": 16, "model": 16}}


class TestDryRunMachinery:
    def test_all_cells_enumerable(self):
        """40 (arch x shape) cells exist; skips are exactly the documented
        long_500k inapplicables."""
        cells = [(a, s) for a in list_archs() for s in SHAPES]
        assert len(cells) == 40
        skips = [c for c in cells
                 if not shape_applicable(get_config(c[0]), SHAPES[c[1]])[0]]
        assert len(skips) == 6
        assert all(s == "long_500k" for _, s in skips)

    def test_batch_specs_cover_inputs(self):
        for arch in list_archs():
            cfg = get_config(arch)
            for sname, shape in SHAPES.items():
                specs = batch_specs(cfg, shape)
                assert "tokens" in specs
                if shape.kind == "train":
                    assert specs["targets"].shape == (
                        shape.global_batch, shape.seq_len)
                if cfg.family == "vlm" and shape.kind != "decode":
                    assert "patches" in specs
                assert all(t.device.type == "meta" for t in specs.values())

    def test_default_microbatches_divide(self):
        for arch in list_archs():
            cfg = get_config(arch)
            mb = default_microbatches(cfg, SHAPES["train_4k"],
                                      FakeMesh(MESHES["single"]))
            assert SHAPES["train_4k"].global_batch % mb == 0

    def test_collective_bytes_parser(self):
        # the reference's HLO lines as the counter records them:
        # (kind, output bytes, group size) -> calls
        out = collective_bytes({("all-reduce", 128 * 256 * 4, 2): 1,
                                ("all-gather", 64 * 64 * 2, 4): 1,
                                ("reduce-scatter", 8 * 64 * 2, 8): 1})
        counts = out.pop("_counts")
        assert counts["all-reduce"] == 1 and counts["all-gather"] == 1
        # all-reduce over groups of 2: 128*256*4 * 2*(2-1)/2
        assert out["all-reduce"] == pytest.approx(128 * 256 * 4 * 1.0)
        # all-gather over groups of 4: 64*64*2 * (4-1)/4
        assert out["all-gather"] == pytest.approx(64 * 64 * 2 * 0.75)
        # reduce-scatter over groups of 8: 8*64*2 * (8-1)
        assert out["reduce-scatter"] == pytest.approx(8 * 64 * 2 * 7)

    def test_dot_bytes_parser(self):
        # a bf16 [128,64] x [64,32] matmul with a float32 output
        ops = {"mm": [1, 128 * 64 * 2 + 64 * 32 * 2, 128 * 32 * 4],
               "add": [3, 10 ** 6, 10 ** 6]}
        got = dot_bytes(ops)
        assert got == pytest.approx(128 * 64 * 2 + 64 * 32 * 2 + 128 * 32 * 4)

    def test_roofline_terms(self):
        t = RooflineTerms(
            arch="x", shape="train_4k", mesh="single", chips=256,
            hlo_flops=1e18, hlo_bytes=1e15, coll_bytes_link=5e10,
            hbm_bytes_est=5e14, model_flops=6e17,
        )
        assert t.t_compute == pytest.approx(1e18 / (256 * 989e12))
        assert t.t_memory == pytest.approx(5e14 / (256 * 3.35e12))
        assert t.t_collective == pytest.approx(1.0)
        assert t.bottleneck == "compute"
        assert 0 < t.useful_ratio < 1
        assert t.roofline_fraction == pytest.approx(1.0)  # compute-bound
        coll = RooflineTerms(
            arch="x", shape="s", mesh="m", chips=256,
            hlo_flops=1e16, hlo_bytes=1e15, coll_bytes_link=5e11,
            hbm_bytes_est=5e14, model_flops=6e15,
        )
        assert coll.bottleneck == "collective"
        assert coll.roofline_fraction < 0.1

    def test_model_flops_kinds(self):
        cfg = get_config("qwen2.5-3b")
        n = 3e9
        tr = model_flops(cfg, SHAPES["train_4k"], n, n)
        pf = model_flops(cfg, SHAPES["prefill_32k"], n, n)
        dc = model_flops(cfg, SHAPES["decode_32k"], n, n)
        assert tr == pytest.approx(6 * n * 256 * 4096)
        assert pf == pytest.approx(2 * n * 32 * 32768)
        assert dc == pytest.approx(2 * n * 128)


def test_batch_specs_equal_the_reference_for_every_cell():
    import jax.numpy as jnp
    from repro.configs import SHAPES as REF_SHAPES, get_config as ref_config
    from repro.launch.specs import batch_specs as ref_specs

    dtypes = {jnp.int32: "int32", jnp.float32: "float32",
              jnp.bfloat16: "bfloat16"}
    n = 0
    for arch in list_archs():
        for sname in SHAPES:
            got = batch_specs(get_config(arch), SHAPES[sname])
            want = ref_specs(ref_config(arch), REF_SHAPES[sname])
            assert list(got) == list(want), (arch, sname)
            for k in want:
                assert tuple(got[k].shape) == tuple(want[k].shape)
                assert str(got[k].dtype) == "torch." + dtypes[
                    want[k].dtype.type], (arch, sname, k)
            n += 1
    assert n == 40


def test_default_microbatches_equal_the_reference():
    from repro.configs import SHAPES as REF_SHAPES, get_config as ref_config
    from repro.launch.specs import default_microbatches as ref_mb

    for arch in list_archs():
        for mesh in MESHES.values():
            for policy in ("baseline", "dp2d", "sp", "serve"):
                for sname in SHAPES:
                    assert default_microbatches(
                        get_config(arch), SHAPES[sname], FakeMesh(mesh),
                        policy) == ref_mb(ref_config(arch), REF_SHAPES[sname],
                                          FakeMesh(mesh), policy)


def test_link_factors_and_collective_bytes_equal_the_reference():
    from repro.roofline import analysis as ref

    kinds = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
             "collective-permute")
    for kind in kinds:
        for n in (1, 2, 4, 16, 32, 512):
            assert analysis._link_factor(kind, n) == ref._link_factor(kind, n)
    # the same collectives as HLO lines and as the counter's records
    lines, records = [], {}
    for i, (kind, shape, n) in enumerate((
            ("all-gather", (64, 64), 16), ("all-reduce", (128, 256), 16),
            ("reduce-scatter", (8, 64), 2), ("all-to-all", (32, 32), 4),
            ("all-reduce", (128, 256), 16))):
        lines.append(f"%c{i} = bf16[{shape[0]},{shape[1]}]{{1,0}} {kind}"
                     f"(%x), replica_groups=[{512 // n},{n}]<=[512]")
        key = (kind, shape[0] * shape[1] * 2, n)
        records[key] = records.get(key, 0) + 1
    assert collective_bytes(records) == ref.collective_bytes("\n".join(lines))


def test_roofline_terms_equal_the_reference_with_its_constants(monkeypatch):
    from repro.roofline import analysis as ref

    monkeypatch.setattr(analysis, "PEAK_FLOPS", ref.PEAK_FLOPS)
    monkeypatch.setattr(analysis, "HBM_BW", ref.HBM_BW)
    monkeypatch.setattr(analysis, "LINK_BW", ref.ICI_BW)
    for kw in (dict(hlo_flops=1e18, hlo_bytes=1e15, coll_bytes_link=5e10,
                    hbm_bytes_est=5e14, model_flops=6e17),
               dict(hlo_flops=1e16, hlo_bytes=1e15, coll_bytes_link=5e11,
                    hbm_bytes_est=0.0, model_flops=6e15,
                    coll_by_kind={"all-gather": 1.0},
                    per_device_memory=2.0 ** 34),
               dict(hlo_flops=0.0, hlo_bytes=3e12)):
        base = dict(arch="x", shape="train_4k", mesh="single", chips=256)
        assert RooflineTerms(**base, **kw).row() == ref.RooflineTerms(
            **base, **kw).row()


def _rows():
    """Dry-run rows of both meshes: ok, skip and fail."""
    rows = []
    for i, (arch, shape) in enumerate(
            (a, s) for a in ("qwen2.5-3b", "zamba2-7b", "llama3-405b")
            for s in SHAPES):
        for mesh in ("single", "multi"):
            base = {"arch": arch, "shape": shape, "mesh": mesh}
            if shape == "long_500k" and arch != "zamba2-7b":
                rows.append({**base, "status": "skip",
                             "reason": "pure full attention: O(seq) KV at "
                                       "500k is not sub-quadratic"})
                continue
            if i == 5:
                rows.append({**base, "status": "fail",
                             "error": "RuntimeError: " + "x" * 80})
                continue
            terms = RooflineTerms(
                arch=arch, shape=shape, mesh=mesh,
                chips=512 if mesh == "multi" else 256,
                hlo_flops=1.5e17 * (i + 1), hlo_bytes=3e15 / (i + 1),
                coll_bytes_link=2.5e9 * i, hbm_bytes_est=7e14 + i,
                model_flops=1e17, per_device_memory=3.3e10 + i * 2 ** 28)
            rows.append({**terms.row(), "status": "ok", "coll_counts": {
                "all-gather": 3 * i, "all-reduce": i, "reduce-scatter": 0,
                "all-to-all": i % 2, "collective-permute": 0}})
    return rows


def _write(rows, d: Path):
    d.mkdir(parents=True, exist_ok=True)
    for r in rows:
        (d / f"{r['arch']}__{r['shape']}__{r['mesh']}.json").write_text(
            json.dumps(r))


def test_report_tables_byte_identical_to_the_reference(tmp_path, monkeypatch):
    from repro.launch import report as ref_report

    rows = _rows()
    _write(rows, tmp_path / "torch")
    _write(rows, tmp_path / "ref")
    monkeypatch.setattr(report, "DIR", str(tmp_path / "torch"))
    monkeypatch.setattr(ref_report, "DIR", str(tmp_path / "ref"))
    for mesh in ("single", "multi"):
        assert report.dryrun_table(mesh) == ref_report.dryrun_table(mesh)
        assert report.roofline_table(mesh) == ref_report.roofline_table(mesh)
    assert "FAIL" in report.dryrun_table("single")
    assert "SKIP" in report.dryrun_table("multi")


def test_roofline_table_rows_byte_identical_to_the_reference(tmp_path,
                                                             monkeypatch):
    from benchmarks import roofline_table as ref_table
    from benchmarks import roofline_table_torch as table

    _write(_rows(), tmp_path)
    monkeypatch.setattr(table, "DRYRUN_DIR", str(tmp_path))
    monkeypatch.setattr(ref_table, "DRYRUN_DIR", str(tmp_path))
    outs = []
    for fn in (table.main, ref_table.main):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            fn()
        outs.append(buf.getvalue())
    assert outs[0] == outs[1]
    assert outs[0].count("\n") > 10


def test_dryrun_main_needs_a_card_or_device_cpu():
    import torch

    from repro_torch.launch import dryrun

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        dryrun.main(["--arch", "qwen2.5-3b", "--shape", "decode_32k"])


# -- one cell counted by both packages --------------------------------------

_REF_CELL = r"""
import json, math, re, sys
import jax, numpy as np
from jax.sharding import Mesh
from repro.configs import ARCHS, SHAPES, smoke_config
from repro.launch.specs import make_cell
from repro.train.train_step import TrainHParams

mesh = Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"))
cfg = smoke_config(ARCHS["qwen2.5-3b"])
nb = SHAPES["train_4k"].seq_len // cfg.attn_block_kv
# the fit variant, every block loop unrolled (no while loop is left)
vcfg = cfg.replace(n_layers=2, unroll_inner=nb, unroll_layers=True,
                   remat_groups=0)
cell = make_cell("qwen2.5-3b", "train_4k", mesh,
                 hp=TrainHParams(microbatches=1), cfg_override=vcfg)
with mesh:
    jitted = jax.jit(cell.fn, in_shardings=tuple(cell.in_shardings),
                     out_shardings=cell.out_shardings,
                     donate_argnums=cell.donate)
    compiled = jitted.lower(*cell.kwargs.values()).compile(
        compiler_options={"xla_backend_optimization_level": 0,
                          "xla_llvm_disable_expensive_passes": True})
text = compiled.as_text()

# the dot FLOPs parser: 2 x output elements x the left operand's
# contracted extent, operand shapes from their definitions
DEF = re.compile(r"%([\w\.\-]+) = (\w+)\[([\d,]*)\]")
dims_of = {m.group(1): [int(d) for d in m.group(3).split(",") if d]
           for m in DEF.finditer(text)}
dot_flops = 0
for line in text.splitlines():
    if " dot(" not in line:
        continue
    out = [int(d) for d in DEF.search(line).group(3).split(",") if d]
    lhs = re.search(r" dot\(([^)]*)\)", line).group(1).split(",")[0]
    con = re.search(r"lhs_contracting_dims=\{([\d,]*)\}", line).group(1)
    shape = dims_of[lhs.strip().lstrip("%")]
    dot_flops += 2 * math.prod(out) * math.prod(
        shape[int(c)] for c in con.split(",") if c)
print(json.dumps({"arg": int(compiled.memory_analysis().argument_size_in_bytes),
                  "whiles": text.count(" while("),
                  "dot_flops": float(dot_flops)}))
"""

_PORT_CELL = r"""
import json
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs import ARCHS, smoke_config
from repro_torch.launch import dryrun

dryrun.fake_world(4)
mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
cfg = smoke_config(ARCHS["qwen2.5-3b"])
counted = []
count_cell = dryrun.count_cell

def recording(cell, device):
    counted.append((cell.cfg.n_layers, count_cell(cell, device)))
    return counted[-1][1]

dryrun.count_cell = recording
# the reference's fit variant: 2 layers, one microbatch (the fit counts it)
at_cell = dryrun._fit_metrics("qwen2.5-3b", "train_4k", mesh,
                              cfg.replace(n_layers=2), 1, "cpu")
variant = dict(counted)[2]
print(json.dumps({"variant": variant, "at_cell": at_cell}))
"""


def _start(code: str, env: dict) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, "-c", textwrap.dedent(code)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env, cwd=str(ROOT))


def _end(proc: subprocess.Popen) -> dict:
    try:
        out, err = proc.communicate(timeout=TIMEOUT)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-4000:]
    return json.loads(out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def cell_counts():
    """The reference's compile and the port's counts, side by side."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    ref = _start(_REF_CELL, dict(
        env, XLA_FLAGS="--xla_force_host_platform_device_count=4"))
    port = _start(_PORT_CELL, env)
    try:
        got = _end(port)
    finally:
        want = _end(ref)
    return got, want


def test_cell_flops_and_argument_bytes_against_the_reference(cell_counts):
    got, want = cell_counts
    assert want["whiles"] == 0
    cfg = ARCHS["qwen2.5-3b"]
    from repro_torch.configs import smoke_config

    sc = smoke_config(cfg)
    S, B = SHAPES["train_4k"].seq_len, SHAPES["train_4k"].global_batch
    nb = S // sc.attn_block_kv
    # one Q K^T a KV block and layer, on this device's batch (B / 2) and
    # query heads (Hq / 2): 2 x B S Hq block D
    shared = 2 * nb * (2 * (B // 2) * (sc.n_heads // 2) * S
                       * sc.attn_block_kv * sc.head_dim)
    assert got["variant"]["flops"] - shared == pytest.approx(
        want["dot_flops"], rel=FLOPS_TOL)
    assert got["variant"]["mem"]["argument_size_in_bytes"] == want["arg"]


def test_fit_metrics_equal_the_full_count(cell_counts):
    """The fit of the cell from its shallow variants equal to the cell's
    own count: every metric, the temporaries too."""
    got, _ = cell_counts
    fit, full = got["at_cell"], got["variant"]
    for key in ("flops", "bytes", "dot_bytes", "coll_total"):
        assert fit[key] == pytest.approx(full[key], rel=1e-9), key
    assert fit["coll_counts"] == full["coll_counts"]
    assert fit["temp_size_in_bytes"] == pytest.approx(
        full["mem"]["temp_size_in_bytes"], rel=1e-9)
