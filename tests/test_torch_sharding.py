"""The port's rule tables (``repro_torch.distributed.sharding``) and mesh
constructors against the reference's.

Meshes here are names and sizes only: the reference resolves its specs on a
``jax.sharding.AbstractMesh``, the port on an object with the same axis
names and sizes, so every rule is compared without devices or a process
group.
"""
import jax
import pytest
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as P

from repro.configs import ARCHS as REF_ARCHS
from repro.distributed import sharding as ref_sh
from repro.models.layers import logical_to_pspec as ref_logical_to_pspec
from repro.zoo import get_api as ref_get_api
from repro_torch.configs import ARCHS
from repro_torch.distributed import sharding as sh
from repro_torch.models.layers import ParamSpec, logical_to_pspec
from repro_torch.tree import leaf_paths
from repro_torch.zoo import get_api

AXIS_SETS = [("data", "model"), ("pod", "data", "model")]
POLICIES = ["baseline", "dp2d", "sp", "serve"]
MESH_SHAPES = [((4, 2), ("data", "model")), ((2, 4), ("data", "model")),
               ((1, 1), ("data", "model")), ((8, 1), ("data", "model")),
               ((2, 2, 2), ("pod", "data", "model")),
               ((2, 1, 4), ("pod", "data", "model"))]


class FakeMesh:
    """Axis names and sizes, the reference tests' stand-in for a mesh."""

    def __init__(self, shape, names):
        self.axis_names = tuple(names)
        self.shape = dict(zip(names, shape))


def _ref_specs(cfg) -> dict:
    tree = ref_get_api(cfg).param_specs(cfg)
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: hasattr(x, "axes"))[0]
    return {tuple(p.key for p in path): s for path, s in flat}


def _port_specs(cfg) -> dict:
    return dict(leaf_paths(get_api(cfg).param_specs(cfg)))


# -- the reference's TestShardingRules, on the port ----------------------------

def test_param_specs_resolve():
    """Every arch's full-size ParamSpec tree resolves to valid specs."""
    rules = sh.param_rules(FakeMesh((1, 1), ("data", "model")))
    for arch, cfg in ARCHS.items():
        for path, s in leaf_paths(get_api(cfg).param_specs(cfg)):
            assert isinstance(s, ParamSpec), (arch, path)
            spec = logical_to_pspec(s.axes, rules)
            assert isinstance(spec, tuple)
            assert len(spec) == len(s.shape)


def test_fsdp_shards_weights_over_data():
    r = sh.param_rules(FakeMesh((2, 2, 2), ("pod", "data", "model")))
    assert r["embed"] == ("pod", "data")
    assert r["mlp"] == "model"


def test_act_rules_batch():
    assert sh.act_rules(FakeMesh((2, 2), ("data", "model")))["batch"] == "data"
    assert sh.act_rules(FakeMesh((2, 2, 2), ("pod", "data", "model")))[
        "batch"] == ("pod", "data")


# -- rule tables and specs equal the reference's ------------------------------

@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_specs_equal_the_reference_for_every_policy(arch):
    """For the arch's full-size ParamSpec tree, under both axis-name sets and
    all four policies (and fsdp off), every leaf's spec equals the
    reference's PartitionSpec entry for entry; the activation rules equal
    the reference's too."""
    mine, ref = _port_specs(ARCHS[arch]), _ref_specs(REF_ARCHS[arch])
    assert sorted(mine) == sorted(ref)
    for names in AXIS_SETS:
        m = FakeMesh((1,) * len(names), names)
        for policy in POLICIES:
            for fsdp in (True, False):
                rules = sh.param_rules(m, fsdp=fsdp, policy=policy)
                assert rules == ref_sh.param_rules(m, fsdp=fsdp, policy=policy)
                for path, s in mine.items():
                    want = ref_logical_to_pspec(ref[path].axes, rules)
                    assert isinstance(want, P)
                    assert logical_to_pspec(s.axes, rules) == tuple(want), (
                        names, policy, path)
            for seq_shard in (False, True):
                assert sh.act_rules(m, seq_shard, policy) == \
                    ref_sh.act_rules(m, seq_shard, policy)
        assert sh.batch_axes(m) == ref_sh.batch_axes(m)


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "deepseek-moe-16b"])
def test_state_shardings_equal_the_reference(arch):
    cfg = ARCHS[arch]
    ref = _ref_specs(REF_ARCHS[arch])
    for shape, names in MESH_SHAPES:
        got = dict(leaf_paths(sh.state_shardings(
            get_api(cfg).param_specs(cfg), FakeMesh(shape, names))))
        rules = ref_sh.param_rules(AbstractMesh(shape, names))
        for path, ns in got.items():
            assert isinstance(ns, sh.NamedSharding)
            assert ns.spec == tuple(
                ref_logical_to_pspec(ref[path].axes, rules)), path


BATCH_SHAPES = {"tokens": (8, 32), "targets": (6, 32), "loss_mask": (4, 32),
                "one": (1, 16), "patches": (16, 8, 48), "scalar": ()}

CACHE_SHAPES = {
    "k": (4, 8, 512, 2, 32),          # (layers, B, S, H, D): S over model
    "v": (4, 8, 100, 2, 32),          # S not a multiple of model x 128
    "k1": (4, 1, 2048, 2, 32),        # batch 1: only S is sharded
    "pos": (8,),
    "state": (4, 2, 16, 32),
    "short": (3,),
}


class _Shape:
    def __init__(self, shape):
        self.shape = shape


@pytest.mark.parametrize("shape,names", MESH_SHAPES)
def test_batch_and_cache_shardings_equal_the_reference(shape, names):
    """Specs of batches and decode caches at smoke shapes -- divisibility
    guards included -- equal the reference's on the same mesh shape."""
    port_mesh, ref_mesh = FakeMesh(shape, names), AbstractMesh(shape, names)
    ref_tree = lambda shapes: {k: jax.ShapeDtypeStruct(v, "float32")
                               for k, v in shapes.items()}
    port_tree = lambda shapes: {k: _Shape(v) for k, v in shapes.items()}
    for policy in ("baseline", "dp2d"):
        got = sh.batch_shardings(port_tree(BATCH_SHAPES), port_mesh, policy)
        want = ref_sh.batch_shardings(ref_tree(BATCH_SHAPES), ref_mesh,
                                      policy)
        for k in BATCH_SHAPES:
            assert got[k].spec == tuple(want[k].spec), (policy, k)
    for batch_dim in (1, 0):
        got = sh.cache_shardings(port_tree(CACHE_SHAPES), port_mesh,
                                 batch_dim)
        want = ref_sh.cache_shardings(ref_tree(CACHE_SHAPES), ref_mesh,
                                      batch_dim)
        for k in CACHE_SHAPES:
            assert got[k].spec == tuple(want[k].spec), (batch_dim, k)


def test_placements_of_a_multi_axis_entry():
    from torch.distributed.tensor import Replicate, Shard

    m = FakeMesh((2, 2, 2), ("pod", "data", "model"))
    assert sh.placements((("pod", "data"), None), m) == (
        Shard(0), Shard(0), Replicate())
    assert sh.placements((None, "model", ("pod", "data")), m) == (
        Shard(2), Shard(2), Shard(1))
    assert sh.placements((), m) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="order"):
        sh.placements((("data", "pod"),), m)
    with pytest.raises(ValueError, match="two dims"):
        sh.placements(("data", "data"), m)


# -- meshes --------------------------------------------------------------------

def test_meshes_refuse_without_the_ranks_or_the_card():
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_local_mesh, make_production_mesh

    assert not dist.is_initialized()
    for multi_pod, n in ((False, 256), (True, 512)):
        with pytest.raises(ValueError, match=f"needs {n} ranks"):
            make_production_mesh(multi_pod=multi_pod, device="cpu")
    with pytest.raises(ValueError, match="needs 2 ranks"):
        make_local_mesh(data=2, device="cpu")
    assert not dist.is_initialized()     # refused before starting a group
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_local_mesh()
        with pytest.raises(RuntimeError, match="CUDA"):
            make_local_mesh(device="cuda")


def test_local_mesh_takes_torchrun_s_world(monkeypatch):
    """Under ``torchrun`` (its environment: ``WORLD_SIZE``, ``MASTER_ADDR``,
    ...) the mesh is over the world it names, and the group is started from
    that environment, not from a ``HashStore`` of one."""
    import socket

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_local_mesh

    with socket.socket() as s:          # a free localhost port
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(WORLD_SIZE="2", RANK="0", LOCAL_RANK="0",
               MASTER_ADDR="localhost", MASTER_PORT=str(port))
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError, match="needs 1 ranks; the process group "
                                         "has 2"):
        make_local_mesh(data=1, device="cpu")
    assert not dist.is_initialized()
    monkeypatch.setenv("WORLD_SIZE", "1")
    try:
        mesh = make_local_mesh(device="cpu")
        assert dist.get_world_size() == 1
        assert type(dist.distributed_c10d._get_default_store()).__name__ \
            != "HashStore"
        assert mesh.mesh_dim_names == ("data", "model")
    finally:
        dist.destroy_process_group()
