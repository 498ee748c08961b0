"""The port's distribution rules, collective helpers, elastic re-meshing and
meshes, held against ``repro.distributed`` on the same shapes.

The rules read only a mesh's shape, so they run on ``MeshShape``s of
(16, 16) and (2, 16, 16), where the reference's tests use a ``FakeMesh``;
a port spec equals the reference's ``tuple(PartitionSpec)`` (the port
writes jax 0.9.0's normal form).  What needs a process group runs in a
one-rank gloo world made per test (a ``FileStore`` under ``tmp_path``).
The reference's cases are ``tests/test_distributed.py`` and
``tests/test_fault_tolerance.py::test_elastic_remesh_and_reshard``.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro.configs import ARCHITECTURES as REF_ARCHS
from repro.configs import get_config as ref_config
from repro.distributed import sharding as RS
from repro.models import param_specs as ref_param_specs
from repro_torch.configs import ARCHITECTURES, get_config, reduced_config
from repro_torch.distributed import (
    MeshShape,
    Sharding,
    axis_sizes,
    batch_spec,
    bucketed_psum,
    cache_spec,
    choose_mesh_shape,
    cross_pod_mean,
    make_elastic_mesh,
    opt_state_shardings,
    param_layout,
    param_spec,
    params_shardings,
    psum_tree,
    reshard_state,
)
from repro_torch.distributed.collectives import bucket_leaves
from repro_torch.distributed.sharding import batch_axes
from repro_torch.launch.mesh import make_production_mesh, make_smoke_mesh
from repro_torch.models import init_params, param_specs

MESH1 = MeshShape(("data", "model"), (16, 16))
MESH2 = MeshShape(("pod", "data", "model"), (2, 16, 16))


class FakeMesh:
    """The reference's shape-only stand-in."""

    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


def _fake(mesh):
    return FakeMesh(dict(zip(mesh.names, mesh.sizes)))


@pytest.fixture
def world(tmp_path):
    import torch.distributed as dist

    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------------------ rules
def test_weight_spec_fsdp_plus_tp():
    s2 = param_spec("/layers/mlp/wi/w", (88, 12288, 28672), MESH2, stacked=True)
    assert s2[0] is None
    assert {x for x in s2[1:] if x} == {("pod", "data"), "model"}
    assert s2 == tuple(RS.param_spec("/layers/mlp/wi/w", (88, 12288, 28672), _fake(MESH2),
                                     stacked=True))


def test_vocab_parallel_embedding():
    s = param_spec("/embed/unembed", (5120, 202240), MESH1)
    assert s[1] == "model"           # vocab on model -> vocab-parallel logits
    assert s == ("data", "model")
    s = param_spec("/embed/tok", (202240, 5120), MESH1)
    assert s[0] == "model"


def test_moe_expert_sharding_divisible():
    s = param_spec("/layers/moe/wi", (48, 16, 5120, 8192), MESH1, stacked=True)
    assert s[1] == "model"           # 16 experts over the 16-way model axis
    # 40 experts do not divide 16: the ffn dim takes model
    s = param_spec("/layers/moe/wi", (32, 40, 1536, 512), MESH1, stacked=True)
    assert s[1] is None and s[3] == "model"


def test_indivisible_dims_replicate():
    assert param_spec("/x/w", (7, 13), MESH1) == (None, None)


def test_batch_axes_divisibility():
    assert batch_axes(MESH2, 256) == ("pod", "data")
    assert batch_axes(MESH2, 2) == ("pod",)
    assert batch_axes(MESH2, 1) == ()
    assert batch_axes(MESH1, 32) == ("data",)
    assert batch_spec(MESH1, 1, 2) == (None, None)
    assert batch_spec(MESH2, 256, 3) == (("pod", "data"), None, None)


def test_cache_spec_heads_else_head_dim():
    s = cache_spec("/k", (24, 128, 32768, 16, 64), MESH1, 128)
    assert s[3] == "model" and s[1] == "data"
    s = cache_spec("/k", (88, 128, 32768, 8, 128), MESH1, 128)
    assert s[4] == "model" and s[2] is None and s[3] is None
    s = cache_spec("/k_scale", (88, 128, 32769, 8), MESH1, 128)
    assert s[1] == "data" and s[3] is None
    s = cache_spec("/mamba/ssm", (48, 1, 64, 64, 128), MESH1, 1)
    assert s[2] == "model"


def test_params_shardings_cover_every_leaf():
    specs = param_specs(get_config("qwen2.5-14b"))
    mesh = MeshShape(("data", "model"), (1, 1))
    shard = params_shardings(specs, mesh)

    def same_structure(a, b):
        if isinstance(a, dict):
            return isinstance(b, dict) and a.keys() == b.keys() and \
                all(same_structure(a[k], b[k]) for k in a)
        return isinstance(b, Sharding) and len(b.spec) == a.ndim and \
            len(b.placements) == 2 and b.mesh is mesh

    assert same_structure(specs, shard)


def _param_leaves(tree, path="", stacked=False, out=None):
    out = [] if out is None else out
    if isinstance(tree, dict):
        for k, v in tree.items():
            _param_leaves(v, f"{path}/{k}", stacked or k in ("layers", "enc_layers"), out)
    else:
        out.append((path, tuple(tree.shape), stacked))
    return out


@pytest.mark.parametrize("name", list(ARCHITECTURES))
def test_every_arch_params_have_valid_specs(name):
    """No param dim is sharded by axes that do not divide it, on the port's
    full-width shapes (meta tensors); and every spec, layout and cache spec
    is the reference's on its own shapes, which are the same."""
    assert set(ARCHITECTURES) == set(REF_ARCHS)
    leaves = _param_leaves(param_specs(get_config(name)))
    assert sorted(leaves) == sorted(_param_leaves(ref_param_specs(ref_config(name))))
    sizes = axis_sizes(MESH2)
    for path, shape, stacked in leaves:
        spec = param_spec(path, shape, MESH2, stacked=stacked)
        for dim, ax in zip(shape, spec, strict=True):
            if ax is None:
                continue
            n = int(np.prod([sizes[a] for a in (ax if isinstance(ax, tuple) else (ax,))]))
            assert dim % n == 0, (name, path, shape, spec)
        for mesh in (MESH1, MESH2, MeshShape(("data", "model"), (4, 16))):
            fake = _fake(mesh)
            assert param_spec(path, shape, mesh, stacked) == \
                tuple(RS.param_spec(path, shape, fake, stacked)), (name, path)
            assert param_layout(path, shape, mesh, stacked) == \
                RS.param_layout(path, shape, fake, stacked)
            for gb in (1, 32, 256):
                assert cache_spec(path, shape, mesh, gb) == \
                    tuple(RS.cache_spec(path, shape, fake, gb))


def test_param_spec_fallback_small_dim_to_fsdp():
    # model (16) does not divide 24 and fsdp (4) does not divide 30: the
    # small dim takes the fsdp axes, written as the axis name
    mesh = MeshShape(("data", "model"), (4, 16))
    s = param_spec("/x/w", (30, 24), mesh)
    assert s == (None, "data")
    assert s == tuple(RS.param_spec("/x/w", (30, 24), _fake(mesh)))


def test_param_layout_bridges_spec_to_stitch_layout():
    assert param_layout("/embed/unembed", (5120, 202240), MESH1) == (("data",), ("model",))
    assert param_layout("/x/w", (7, 13), MESH1) == (None, None)


def test_opt_state_shardings_mirror_params():
    from torch.distributed.tensor import Replicate, Shard

    mesh = MeshShape(("data", "model"), (1, 1))
    pshard = params_shardings({"w": torch.empty(4, 8, device="meta")}, mesh)
    assert pshard["w"].spec == param_spec("/w", (4, 8), mesh) == ("model", "data")
    assert pshard["w"].placements == (Shard(1), Shard(0))   # data splits dim 1, model dim 0
    o = opt_state_shardings(None, pshard, mesh)
    assert o.m["w"] is pshard["w"] and o.v["w"] is pshard["w"]
    assert o.m is not pshard
    assert o.step.spec == () and o.step.placements == (Replicate(), Replicate())


def test_axis_sizes_reads_every_mesh_form():
    assert axis_sizes(MESH2) == {"pod": 2, "data": 16, "model": 16}
    assert axis_sizes(_fake(MESH1)) == {"data": 16, "model": 16}
    assert axis_sizes(SimpleNamespace(mesh_dim_names=("data",), shape=(4,))) == {"data": 4}


# ------------------------------------------------------------ collectives
def test_bucketing_groups_by_bytes():
    tree = {f"w{i}": torch.zeros(1024, 1024) for i in range(8)}
    buckets = bucket_leaves(tree, bucket_bytes=8 * 1024 * 1024)   # 2 leaves each
    assert all(len(b) == 2 for b in buckets)
    assert sum(len(b) for b in buckets) == 8


def test_cross_pod_mean_reduces(world, tmp_path):
    from torch.distributed.device_mesh import init_device_mesh

    mesh = init_device_mesh("cpu", (1, 1, 1), mesh_dim_names=("pod", "data", "model"))
    g = {"w": torch.arange(8.0)}
    out = cross_pod_mean(g, mesh, compress="bf16")
    np.testing.assert_allclose(out["w"].numpy(), np.arange(8.0), atol=1e-2)
    flat = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
    assert cross_pod_mean(g, flat) is g


def test_bucketed_psum_keeps_structure_and_dtype(world):
    from torch.distributed.device_mesh import init_device_mesh

    mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("data",))
    tree = {"b": torch.ones(3, dtype=torch.float64), "a": [torch.arange(4.0), torch.full((2, 2), 3.0)]}
    for compress in ("none", "bf16"):
        out = bucketed_psum(tree, (mesh, "data"), bucket_bytes=16, compress=compress)
        assert list(out) == ["b", "a"] and out["b"].dtype == torch.float64
        assert torch.equal(out["a"][1], tree["a"][1]) and torch.equal(out["b"], tree["b"])
    assert torch.equal(psum_tree(tree, mesh.get_group("data"))["a"][0], tree["a"][0])
    with pytest.raises(ValueError, match="compress"):
        bucketed_psum(tree, (mesh, "data"), compress="int4")


def test_axis_groups_follow_the_mesh_and_the_world(tmp_path):
    """A group over several axes is cached by the mesh's names, shape and
    ranks, and only for the world it was made in."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.core import comm

    names = ("pod", "data", "model")

    def start(n):
        dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / f"store{n}"), 1),
                                rank=0, world_size=1)

    start(0)
    try:
        mesh = init_device_mesh("cpu", (1, 1, 1), mesh_dim_names=names)
        first = comm.axis_group(mesh, ("pod", "data"))
        assert comm.group_names(mesh)[first.group_name] == ("pod", "data")
        # the same mesh made again shares the group; another mesh does not see it
        again = init_device_mesh("cpu", (1, 1, 1), mesh_dim_names=names)
        assert comm.axis_group(again, ("pod", "data")) is first
        other = init_device_mesh("cpu", (1, 1), mesh_dim_names=("pod", "data"))
        assert ("pod", "data") not in comm.group_names(other).values()
    finally:
        dist.destroy_process_group()
    start(1)
    try:
        mesh = init_device_mesh("cpu", (1, 1, 1), mesh_dim_names=names)
        fresh = comm.axis_group(mesh, ("pod", "data"))
        assert fresh is not first
        assert comm.group_names(mesh)[fresh.group_name] == ("pod", "data")
        v = torch.arange(3.0)
        assert torch.equal(comm.all_reduce(v, fresh), v)
    finally:
        dist.destroy_process_group()


# ----------------------------------------------------------------- elastic
def test_choose_mesh_shape_validation():
    assert choose_mesh_shape(8, 4) == (2, 4)
    assert choose_mesh_shape(6, 4) == (2, 3)
    assert choose_mesh_shape(512, 16) == (32, 16)
    assert choose_mesh_shape(448, 16) == (28, 16)
    with pytest.raises(ValueError, match="num_devices"):
        choose_mesh_shape(0)
    with pytest.raises(ValueError, match="num_devices"):
        choose_mesh_shape(-2, 4)
    with pytest.raises(ValueError, match="prefer_model"):
        choose_mesh_shape(8, 0)
    with pytest.raises(ValueError, match="prefer_model"):
        choose_mesh_shape(8, -1)
    with pytest.raises(ValueError, match="num_devices"):
        make_elastic_mesh(0, prefer_model=4, device="cpu")
    with pytest.raises(ValueError, match="prefer_model"):
        make_elastic_mesh(prefer_model=0, device="cpu")


def test_elastic_remesh_and_reshard(world):
    from repro_torch.train.optimizer import AdamWState

    cfg = reduced_config(get_config("qwen1.5-0.5b"))
    params = init_params(cfg, 0, device="cpu")
    mesh = make_elastic_mesh(device="cpu", prefer_model=1)
    assert tuple(mesh.shape) == (1, 1) and mesh.mesh_dim_names == ("data", "model")
    state = AdamWState(step=torch.zeros((), dtype=torch.int32),
                       m={k: v for k, v in params.items()}, v=params)
    p2, o2 = reshard_state(params, state, mesh)

    def pairs(a, b):
        if isinstance(a, dict):
            for k in a:
                yield from pairs(a[k], b[k])
        else:
            yield a, b

    for a, b in pairs(params, p2):
        assert torch.equal(a, b.full_tensor())
    assert torch.equal(o2.step.full_tensor(), state.step)
    assert all(torch.equal(a, b.full_tensor()) for a, b in pairs(params, o2.m))
    assert reshard_state(params, None, mesh)[1] is None


# ------------------------------------------------------------------- meshes
def test_smoke_and_production_meshes(world):
    mesh = make_smoke_mesh(1, 1, device="cpu")
    assert mesh.mesh_dim_names == ("data", "model") and tuple(mesh.shape) == (1, 1)
    with pytest.raises(RuntimeError, match="256 ranks"):
        make_production_mesh(device="cpu")
    with pytest.raises(RuntimeError, match="512 ranks"):
        make_production_mesh(multi_pod=True, device="cpu")
    with pytest.raises(RuntimeError, match="4 ranks"):
        make_smoke_mesh(2, 2, device="cpu")


def test_production_mesh_needs_a_world():
    with pytest.raises(RuntimeError, match="256 ranks.*none"):
        make_production_mesh(device="cpu")
