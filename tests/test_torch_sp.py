"""The models' sequence-parallel hooks in the port: ``current_mesh`` and
``constrain_sp`` (``repro_torch.distributed.sharding``), the layer hooks
``_constrain_last_dim_model`` and ``_constrain_rows_model``, and
``activation_sharding="sp"`` in ``_scan_layers``, held against the
reference.

``current_mesh`` is the mesh of ``core.comm.mesh_scope``, the port's ``with
mesh:``.  A hook returns a plain tensor (a rank's own value in SPMD) as it
is, and a ``DTensor`` redistributed to the placements the reference's
constraint names: a world of four CPU gloo ranks (spawned once for the
file) redistributes DTensors, and each result's placements are held
against the spec of the reference's constrained array under ``jax.jit`` on
a 2 x 2 mesh of four host devices.  ``forward`` and ``decode_step`` under
``"sp"`` inside a ``mesh_scope`` are held against ``"none"`` and against the
reference's, jitted under ``with mesh:``, at ``tests/test_torch_models.py``'s
tolerance.

This module imports only torch, numpy and pytest at the top, so a spawned
rank imports no jax.
"""
import dataclasses
import datetime
import os
import pickle

import numpy as np
import pytest
import torch

WORLD = 4
MESH = (("data", "model"), (2, 2))
F32_TOL = 2e-5
#: (hook, input shape): the shapes that divide and those that do not
HOOK_CASES = [
    ("constrain_sp", (4, 8, 6)),
    ("constrain_sp", (3, 8, 6)),       # batch does not divide data: replicated
    ("constrain_sp", (4, 5, 6)),       # sequence does not divide model
    ("constrain_sp", (4, 8)),          # fewer than 3 dims: no-op
    ("last_dim_model", (2, 3, 8)),
    ("last_dim_model", (2, 3, 5)),
    ("rows_model", (8, 6)),
    ("rows_model", (5, 6)),
]


def _hook(name):
    from repro_torch.distributed.sharding import constrain_sp
    from repro_torch.models import layers as L

    return {"constrain_sp": constrain_sp, "last_dim_model": L._constrain_last_dim_model,
            "rows_model": L._constrain_rows_model}[name]


def _value(shape):
    return torch.from_numpy(np.random.default_rng(len(shape)).normal(size=shape).astype(np.float32))


def _rank_main(rank, outdir):
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor, Replicate

    from repro_torch.core import comm
    from repro_torch.launch.mesh import make_smoke_mesh

    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(outdir, "store"), WORLD),
                            rank=rank, world_size=WORLD, timeout=datetime.timedelta(seconds=120))
    mesh = make_smoke_mesh(*MESH[1], device="cpu")
    res = []
    for name, shape in HOOK_CASES:
        x = _value(shape)
        dt = distribute_tensor(x, mesh, [Replicate(), Replicate()])
        with comm.mesh_scope(mesh):
            out = _hook(name)(dt)
        res.append(dict(placements=[repr(p) for p in out.placements],
                        same=out is dt, local=tuple(out.to_local().shape),
                        equal=bool(torch.equal(out.full_tensor(), x))))
    with open(os.path.join(outdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    import torch.multiprocessing as mp

    outdir = str(tmp_path_factory.mktemp("sp"))
    mp.spawn(_rank_main, args=(outdir,), nprocs=WORLD, join=True)
    out = []
    for r in range(WORLD):
        with open(os.path.join(outdir, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def _jax_mesh():
    import jax

    return jax.sharding.Mesh(np.array(jax.devices()[:WORLD]).reshape(MESH[1]), MESH[0])


def _reference_placements(name, shape):
    """The placements of the spec the reference's hook puts on an array of
    ``shape`` under ``jax.jit`` on a 2 x 2 mesh; an array it leaves as it
    is comes back on one device, replicated."""
    import jax
    import jax.numpy as jnp

    from repro.distributed.sharding import constrain_sp
    from repro.models import layers as rL
    from repro_torch.core.shard import MeshShape, layout_to_placements, spec_to_layout

    fn = {"constrain_sp": constrain_sp, "last_dim_model": rL._constrain_last_dim_model,
          "rows_model": rL._constrain_rows_model}[name]
    mesh = _jax_mesh()
    with mesh:
        out = jax.jit(fn)(jnp.zeros(shape, jnp.float32))
    spec = tuple(getattr(out.sharding, "spec", ()))
    layout = spec_to_layout(spec, len(shape))
    return [repr(p) for p in layout_to_placements(layout, MeshShape(*MESH))]


def test_current_mesh_is_the_mesh_scope():
    from repro_torch.core import comm
    from repro_torch.core.shard import MeshShape
    from repro_torch.distributed import current_mesh

    assert current_mesh() is None
    mesh = MeshShape(*MESH)
    with comm.mesh_scope(mesh):
        assert current_mesh() is mesh
        inner = MeshShape(("model",), (2,))
        with comm.mesh_scope(inner):
            assert current_mesh() is inner
        assert current_mesh() is mesh
    assert current_mesh() is None


@pytest.mark.parametrize("name,shape", HOOK_CASES, ids=[f"{n}-{s}" for n, s in HOOK_CASES])
def test_hooks_return_plain_tensors_unchanged(name, shape):
    from repro_torch.core import comm
    from repro_torch.core.shard import MeshShape

    x = _value(shape)
    assert _hook(name)(x) is x                       # outside a mesh
    with comm.mesh_scope(MeshShape(*MESH)):
        assert _hook(name)(x) is x                   # a rank's own value


@pytest.mark.parametrize("i", range(len(HOOK_CASES)),
                         ids=[f"{n}-{s}" for n, s in HOOK_CASES])
def test_hooks_redistribute_a_dtensor_as_the_reference_constrains(world, i):
    name, shape = HOOK_CASES[i]
    want = _reference_placements(name, shape)
    for res in world:
        got = res[i]
        assert got["placements"] == want
        assert got["equal"]
        if want == ["Replicate()", "Replicate()"]:
            assert got["same"]
    assert any(not r[i]["same"] for r in world) == (want != ["Replicate()", "Replicate()"])


def _models(arch, **kw):
    from repro import configs as rconfigs
    from repro_torch import configs as tconfigs

    return (rconfigs.reduced_config(rconfigs.get_config(arch), **kw),
            tconfigs.reduced_config(tconfigs.get_config(arch), **kw))


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "granite-moe-3b-a800m"])
def test_sp_forward_equals_none_and_the_reference(arch):
    import jax
    import jax.numpy as jnp

    from repro import models as rmodels
    from repro_torch import models as tmodels
    from repro_torch.core import comm
    from repro_torch.core.shard import MeshShape
    from repro_torch.data import SyntheticLM

    rcfg, tcfg = _models(arch, activation_sharding="sp")
    tnone = dataclasses.replace(tcfg, activation_sharding="none")
    rparams = rmodels.init_params(rcfg, 0)
    tparams = tmodels.params_from_reference(jax.tree.map(np.asarray, rparams), device="cpu")
    batch = SyntheticLM(tcfg, 16, 4, seed=0).batch_at(0)
    with _jax_mesh():
        want = np.asarray(jax.jit(lambda p, b: rmodels.forward(p, b, rcfg))(
            rparams, {k: jnp.asarray(v) for k, v in batch.items()}))
    with comm.mesh_scope(MeshShape(*MESH)):
        got = tmodels.forward(tparams, batch, tcfg)
    none = tmodels.forward(tparams, batch, tnone)
    assert torch.equal(got, none)
    np.testing.assert_allclose(got.numpy(), want, rtol=F32_TOL, atol=F32_TOL)


def test_decode_step_with_the_hook_equals_the_reference():
    import jax
    import jax.numpy as jnp

    from repro import models as rmodels
    from repro_torch import models as tmodels
    from repro_torch.core import comm
    from repro_torch.core.shard import MeshShape

    rcfg, tcfg = _models("qwen1.5-0.5b", activation_sharding="sp")
    rparams = rmodels.init_params(rcfg, 0)
    tparams = tmodels.params_from_reference(jax.tree.map(np.asarray, rparams), device="cpu")
    B = 2
    rcache = rmodels.init_cache(rcfg, B, max_len=16)
    tcache = tmodels.init_cache(tcfg, B, max_len=16, device="cpu")
    step = jax.jit(lambda p, c, t, pos: rmodels.decode_step(p, c, t, pos, rcfg))
    toks = np.random.RandomState(0).randint(0, 200, (B, 5)).astype(np.int32)
    for i in range(5):
        pos = np.full((B,), i, np.int32)
        with _jax_mesh():
            want, rcache = step(rparams, rcache, jnp.asarray(toks[:, i]), jnp.asarray(pos))
        with comm.mesh_scope(MeshShape(*MESH)):
            got, tcache = tmodels.decode_step(tparams, tcache, toks[:, i], pos, tcfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL, atol=F32_TOL)
