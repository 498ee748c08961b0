"""The port's sharded frontend and sharded replay, run by a world of four
CPU gloo ranks and held against the reference's ``jax.jit(shard_map(fn))``.

One world serves the whole file: a module-scoped fixture spawns four ranks
(``torch.multiprocessing``, a ``FileStore`` under the test's temporary
directory, no TCP port), each runs every case in ``_rank_main`` and writes
what it saw, and the tests read those files.  The reference's
``test_stitch_sharded_bitwise_parity`` and
``..._all_gather_reduce_scatter`` fail under the installed jax (its
``shard_map`` capture raises ``KeyError: 'in_names'``), so the JAX side of
each comparison is ``jax.jit(wrap_shard_map(fn))`` of the same function on
four of the eight host devices ``tests/conftest.py`` forces, at ``TOL``.
Within the world, each stitched plan is held against the same torch
function run eagerly on the same blocks (``wrap_shard_map``), and the ranks
against each other, bit for bit.

Capture-only cases (the plan, the fold of a gather along dim 1 into one
collective, the refusal of other collectives) run in this process under
torch's in-process ``fake`` backend, torn down by their fixture.

This module imports only torch, numpy and pytest at the top, so a spawned
rank imports no jax.
"""
import datetime
import functools
import os
import pickle
import warnings

import numpy as np
import pytest
import torch

WORLD = 4
TOL = 2e-5
SEED = 0


# -------------------------------------------------------------- functions
def _gelu(a):
    """The reference's ``jax.nn.gelu`` (its tanh approximation), spelled in
    the ops the frontend lowers."""
    return 0.5 * a * (1.0 + torch.tanh(0.7978845608028654 * (a + 0.044715 * a ** 3)))


def _fc():
    import torch.distributed._functional_collectives as fc

    return fc


def _gather(x, dim, group):
    with warnings.catch_warnings():   # torch 2.13 renames it; 2.11 has only this name
        warnings.simplefilter("ignore", FutureWarning)
        return _fc().all_gather_tensor(x, dim, group)


def _scatter(x, dim, group):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        return _fc().reduce_scatter_tensor(x, "sum", dim, group)


def _mlp_fn(mesh):
    def mlp(x, w1, w2):
        h = _gelu(x @ w1)
        return torch.tanh(_fc().all_reduce(h @ w2, "sum", (mesh, 0)))
    return mlp


def _gs_fn(mesh):
    def gs(x):
        return _scatter(_gather(x, 0, (mesh, 0)) * 2.0, 0, (mesh, 0))
    return gs


def _gather_dim1_fn(mesh):
    def g1(x):
        return torch.exp(_gather(x, 1, (mesh, 0)))
    return g1


def _scatter_dim1_fn(mesh):
    def s1(x):
        return _scatter(torch.tanh(x), 1, (mesh, 0))
    return s1


def _local_fn(x):
    """No collective: under mesh= a sharded plan whose only steps are local."""
    return torch.exp(x) * 2.0


LOCAL_SPECS = dict(in_specs=(("model", None),), out_specs=("model", None))
MLP_SPECS = dict(in_specs=((), (None, "model"), ("model", None)), out_specs=())
GS_SPECS = dict(in_specs=(("model",),), out_specs=("model",))
G1_SPECS = dict(in_specs=((None, "model"),), out_specs=())
S1_SPECS = dict(in_specs=((),), out_specs=(None, "model"))


def _inputs():
    rng = np.random.default_rng(SEED)
    return {
        "mlp": [rng.normal(size=s).astype(np.float32) for s in ((8, 16), (16, 64), (64, 16))],
        "gs": [rng.normal(size=(64,)).astype(np.float32)],
        "g1": [rng.normal(size=(4, 16)).astype(np.float32)],
        "s1": [rng.normal(size=(4, 16)).astype(np.float32)],
        "multi": [rng.normal(size=(4, 6)).astype(np.float32)],
        "local": [rng.normal(size=(8, 3)).astype(np.float32)],
    }


#: the gradient tree of the collective helpers: (shape, dtype) a leaf, in
#: three dtypes so that a bucket packs several
TREE = {
    "b": ((7,), "bfloat16"),
    "a": [((3, 5), "float32"), ((2, 4), "float16"), ((6,), "float32")],
    "c": {"w": ((4, 4), "bfloat16"), "v": ((9,), "float32")},
}
#: bucket sizes: 40 bytes gives several buckets, several dtypes in some
BUCKETS = (40, 16 * 1024 * 1024)
MESH3 = (("pod", "data", "model"), (2, 1, 2))


def _tree_map(fn, tree, path=""):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, f"{path}/{k}") for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v, f"{path}/{i}") for i, v in enumerate(tree)]
    return fn(path, tree)


def _tree_inputs():
    """Each leaf's values on every rank, stacked: (WORLD, *shape) f32, a
    distinct block a rank (rank r's mean is offset by 3 r)."""
    rng = np.random.default_rng(SEED + 1)
    return _tree_map(lambda _, leaf: np.stack([
        (rng.normal(size=leaf[0]) + 3.0 * r).astype(np.float32) for r in range(WORLD)]), TREE)


def _leaves_sorted(tree):
    """Leaves in ``jax.tree.leaves``' order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves_sorted(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves_sorted(v)]
    return [tree]


def _collective_cases():
    """(name, what the port runs, bucket bytes, compress): each over the
    (pod 2, data 1, model 2) mesh."""
    return ([("bucketed", b, c) for b in BUCKETS for c in ("none", "bf16")]
            + [("mean", None, c) for c in ("none", "bf16")]
            + [("psum_model", None, "none")])


# ------------------------------------------------------------- the world
def _rank_collectives(rank, res):
    """The collective helpers on a (pod 2, data 1, model 2) mesh, each rank
    with its own tree; and ``apply_op`` of collectives inside
    ``mesh_scope``."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.core import comm
    from repro_torch.core.ir import GraphBuilder, apply_op
    from repro_torch.distributed import bucketed_psum, cross_pod_mean, psum_tree

    mesh3 = init_device_mesh("cpu", MESH3[1], mesh_dim_names=MESH3[0])
    stacked = _tree_inputs()
    dtype = _tree_map(lambda _, leaf: getattr(torch, leaf[1]), TREE)
    tree = _rebuild_with(_tree_map(lambda _, a: torch.from_numpy(a[rank]), stacked), dtype)

    def seen(out):
        leaves = _leaves_sorted(out)
        return [(str(x.dtype).split(".")[-1], x.float().numpy()) for x in leaves]

    got = {}
    for name, bb, compress in _collective_cases():
        if name == "bucketed":
            got[(name, bb, compress)] = seen(bucketed_psum(tree, (mesh3, "pod"), bucket_bytes=bb,
                                                           compress=compress))
        elif name == "mean":
            got[(name, bb, compress)] = seen(cross_pod_mean(tree, mesh3, compress=compress))
        else:
            got[(name, bb, compress)] = seen(psum_tree(tree, (mesh3, "model")))
    # the reference's own input: one tree, the same on every rank
    same = _rebuild_with(_tree_map(lambda _, a: torch.from_numpy(a[0]), stacked), dtype)
    got[("mean_replicated", None, "bf16")] = seen(cross_pod_mean(same, mesh3, compress="bf16"))
    res["collectives"] = {"got": got,
                          "buckets": {bb: _bucket_dtypes(tree, bb) for bb in BUCKETS}}

    # apply_op outside a plan takes its groups from the mesh in scope
    mesh2 = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    b = GraphBuilder("scope")
    p = b.parameter("x", (4, 6), np.float32)
    ops = {"model": b.all_reduce(p, "model"), "both": b.all_reduce(p, ("data", "model")),
           "gather_data": b.all_gather(p, "data", dim=1, group_size=2)}
    x = torch.from_numpy(_inputs()["multi"][0]) + rank
    with comm.mesh_scope(mesh2):
        res["scope"] = {k: apply_op(t.instr, x).numpy() for k, t in ops.items()}


def _rebuild_with(tree, dtype):
    if isinstance(tree, dict):
        return {k: _rebuild_with(tree[k], dtype[k]) for k in tree}
    if isinstance(tree, list):
        return [_rebuild_with(a, d) for a, d in zip(tree, dtype)]
    return tree.to(dtype)


def _bucket_dtypes(tree, bucket_bytes):
    from repro_torch.distributed.collectives import bucket_leaves

    leaves = _leaves_sorted(tree)
    return [sorted({str(leaves[i].dtype) for i in idx})
            for idx in bucket_leaves(tree, bucket_bytes)]


def _rank_main(rank, outdir):
    """Every multi-rank case on this rank; what it saw goes to a pickle."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch import stitch
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.core import comm
    from repro_torch.core.shard import wrap_shard_map
    from repro_torch.distributed import make_elastic_mesh, params_shardings, reshard_state
    from repro_torch.models import init_params

    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(outdir, "store"), WORLD),
                            rank=rank, world_size=WORLD, timeout=datetime.timedelta(seconds=120))
    mesh = init_device_mesh("cpu", (WORLD,), mesh_dim_names=("model",))
    inputs = {k: [torch.from_numpy(a) for a in v] for k, v in _inputs().items()}
    res = {}

    def run(key, fn, specs):
        f = stitch(fn, mesh=mesh, device="cpu", **specs)
        first = f(*inputs[key])
        again = f(*inputs[key])
        eager = wrap_shard_map(fn, mesh, specs["in_specs"], specs["out_specs"])(*inputs[key])
        s = f.stats
        ex = f._last.compiled.executable
        res[key] = dict(
            out=first.numpy(), again=again.numpy(), eager=eager.numpy(),
            stats={k: getattr(s, k) for k in (
                "replay_mode", "collective_calls", "sharded_instrs",
                "collective_breaks_spanned", "stitched_kernels")},
            launch={k: getattr(ex.launch_stats(), k) for k in (
                "collective_calls", "assembly_gathers", "eager_calls")},
            num_compiles=f.num_compiles,
            collectives=list(ex.execution_plan.collectives),
            text=f.lower().as_text(),
        )

    run("mlp", _mlp_fn(mesh), MLP_SPECS)
    run("gs", _gs_fn(mesh), GS_SPECS)
    run("g1", _gather_dim1_fn(mesh), G1_SPECS)
    run("s1", _scatter_dim1_fn(mesh), S1_SPECS)
    run("local", _local_fn, LOCAL_SPECS)

    # the composed all-gather (gloo's list form) against the native one
    group = mesh.get_group("model")
    x = inputs["multi"][0] + rank
    res["composed"] = {d: (comm.all_gather(x, d, group, "composed").numpy(),
                           comm.all_gather(x, d, group, "native").numpy()) for d in (0, 1)}

    # a group over two mesh dims: ranks differing in both, stacked major first
    mesh2 = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    both = comm.axis_group(mesh2, ("data", "model"))
    res["two_axes"] = (comm.all_gather(x, 0, both).numpy(), comm.all_reduce(x, both).numpy(),
                       comm.group_names(mesh2))

    _rank_collectives(rank, res)

    # elastic re-mesh and reshard of a reduced qwen1.5-0.5b
    params = init_params(reduced_config(get_config("qwen1.5-0.5b")), SEED, device="cpu")
    emesh = make_elastic_mesh(WORLD, prefer_model=2, device="cpu")
    placed, _ = reshard_state(params, None, emesh)
    flat_in, flat_out, placements = [], [], []

    def walk(a, b, s):
        if isinstance(a, dict):
            for k in a:
                walk(a[k], b[k], s[k])
        else:
            flat_in.append(a)
            flat_out.append(b)
            placements.append(s.placements)

    walk(params, placed, params_shardings(params, emesh))
    res["reshard"] = dict(
        mesh=(tuple(emesh.shape), tuple(emesh.mesh_dim_names)),
        equal=all(torch.equal(a, b.full_tensor()) for a, b in zip(flat_in, flat_out)),
        placements_match=all(tuple(b.placements) == tuple(p)
                             for b, p in zip(flat_out, placements)),
        sharded=sum(1 for b in flat_out if b.to_local().numel() < b.numel()),
        leaves=len(flat_out),
    )
    with open(os.path.join(outdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    import torch.multiprocessing as mp

    outdir = str(tmp_path_factory.mktemp("world"))
    mp.spawn(_rank_main, args=(outdir,), nprocs=WORLD, join=True)
    out = []
    for r in range(WORLD):
        with open(os.path.join(outdir, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def _jax_oracle(kind):
    """``jax.jit(wrap_shard_map(fn))`` of the reference's function on four
    host devices, on the same numpy inputs."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    from repro.core.shard import wrap_shard_map

    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("model",))
    args = [jnp.asarray(a) for a in _inputs()[kind]]
    if kind == "mlp":
        def fn(x, w1, w2):
            return jnp.tanh(jax.lax.psum(jax.nn.gelu(x @ w1) @ w2, "model"))
        specs = ((P(), P(None, "model"), P("model", None)), P())
    elif kind == "gs":
        def fn(x):
            g = jax.lax.all_gather(x, "model", axis=0, tiled=True)
            return jax.lax.psum_scatter(g * 2.0, "model", scatter_dimension=0, tiled=True)
        specs = ((P("model"),), P("model"))
    elif kind == "g1":
        def fn(x):
            return jnp.exp(jax.lax.all_gather(x, "model", axis=1, tiled=True))
        specs = ((P(None, "model"),), P())
    else:
        def fn(x):
            return jax.lax.psum_scatter(jnp.tanh(x), "model", scatter_dimension=1, tiled=True)
        specs = ((P(),), P(None, "model"))
    return np.asarray(jax.jit(wrap_shard_map(fn, mesh, *specs))(*args))


@functools.lru_cache(maxsize=None)
def _jax_collectives():
    """The reference's helpers under ``jax.jit`` on four host devices shaped
    (pod 2, data 1, model 2), each device holding its rank's block of the
    same numpy inputs: {case: [rank r's leaves as f32 numpy]}.  The
    reference's ``cross_pod_mean`` takes a tree replicated on every device,
    so for distinct trees the oracle is its body, ``bucketed_psum`` over
    ``pod`` divided by the pod count; the function itself is held on the
    replicated tree (``mean_replicated``)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    from repro.core.shard import wrap_shard_map
    from repro.distributed.collectives import bucketed_psum, cross_pod_mean, psum_tree

    mesh = Mesh(np.array(jax.devices()[:WORLD]).reshape(MESH3[1]), MESH3[0])
    dtype = _tree_map(lambda _, leaf: getattr(jnp, leaf[1]), TREE)
    stacked = _jnp_with(_tree_inputs(), dtype)
    spec = P(MESH3[0])

    def per_rank(body):
        def f(t):
            out = body(jax.tree.map(lambda x: x[0], t))
            return jax.tree.map(lambda x: x[None], out)

        specs = jax.tree.map(lambda _: spec, stacked)
        out = jax.jit(wrap_shard_map(f, mesh, (specs,), specs))(stacked)
        leaves = [np.asarray(x.astype(jnp.float32)) for x in jax.tree.leaves(out)]
        return [[x[r] for x in leaves] for r in range(WORLD)]

    want = {}
    for name, bb, compress in _collective_cases():
        if name == "bucketed":
            body = (lambda t, bb=bb, c=compress: bucketed_psum(t, "pod", bucket_bytes=bb,
                                                                  compress=c))
        elif name == "mean":
            def body(t, c=compress):
                return jax.tree.map(lambda x: x / mesh.shape["pod"],
                                    bucketed_psum(t, "pod", compress=c))
        else:
            body = (lambda t: psum_tree(t, "model"))
        want[(name, bb, compress)] = per_rank(body)
    same = jax.tree.map(lambda x: x[0], stacked)
    out = jax.jit(lambda t: cross_pod_mean(t, mesh, compress="bf16"))(same)
    leaves = [np.asarray(x.astype(jnp.float32)) for x in jax.tree.leaves(out)]
    want[("mean_replicated", None, "bf16")] = [leaves] * WORLD
    return want, [str(x.dtype) for x in jax.tree.leaves(stacked)]


def _jnp_with(tree, dtype):
    import jax.numpy as jnp

    if isinstance(tree, dict):
        return {k: _jnp_with(tree[k], dtype[k]) for k in tree}
    if isinstance(tree, list):
        return [_jnp_with(a, d) for a, d in zip(tree, dtype)]
    return jnp.asarray(tree).astype(dtype)


# ------------------------------------------------------------------ tests
@pytest.mark.parametrize("kind", ["mlp", "gs", "g1", "s1"])
def test_stitch_sharded_matches_jax_and_eager(world, kind):
    want = _jax_oracle(kind)
    for r, res in enumerate(world):
        got = res[kind]
        np.testing.assert_allclose(got["out"], want, rtol=TOL, atol=TOL, err_msg=f"rank {r}")
        np.testing.assert_allclose(got["out"], got["eager"], rtol=TOL, atol=TOL)
        assert np.array_equal(got["again"], got["out"])
        # every rank returns the same global output, bit for bit
        assert np.array_equal(got["out"], world[0][kind]["out"])


def test_stitch_sharded_stats(world):
    mlp = world[0]["mlp"]
    s = mlp["stats"]
    assert s["replay_mode"] == "sharded"
    assert s["collective_calls"] == 1
    assert s["sharded_instrs"] > 0
    # the Megatron MLP fuses compute on both sides of the all-reduce
    assert s["collective_breaks_spanned"] >= 1
    assert mlp["num_compiles"] == 1
    assert mlp["launch"] == {"collective_calls": 1, "assembly_gathers": 0, "eager_calls": 2}
    assert mlp["collectives"] == [(mlp["collectives"][0][0], "all_reduce", ("model",),
                                   "gloo", "native")]
    gs = world[0]["gs"]
    assert gs["stats"]["collective_calls"] == 2
    # the dim-0 sharded output is assembled by one gather after the plan
    assert gs["launch"]["assembly_gathers"] == 1
    assert [c[1] for c in gs["collectives"]] == ["all_gather", "reduce_scatter"]


def test_a_function_without_collectives_plans_local_steps_only(world):
    local = world[0]["local"]
    want = np.exp(_inputs()["local"][0]) * 2.0
    for res in world:
        np.testing.assert_allclose(res["local"]["out"], want, rtol=TOL, atol=TOL)
        assert np.array_equal(res["local"]["out"], res["local"]["eager"])
    assert local["stats"]["replay_mode"] == "sharded"
    assert local["stats"]["collective_calls"] == 0 and local["collectives"] == []
    assert local["launch"]["assembly_gathers"] == 1     # the row-sharded output


def test_gather_and_scatter_along_dim1_fold_into_one_collective(world):
    g1, s1 = world[0]["g1"]["text"], world[0]["s1"]["text"]
    assert g1.count("all_gather(") == 1 and "'dim': 1" in g1 and "concat" not in g1
    assert s1.count("reduce_scatter(") == 1 and "'dim': 1" in s1 and "concat" not in s1
    assert world[0]["g1"]["stats"]["collective_calls"] == 1


def test_composed_all_gather_equals_native(world):
    for r, res in enumerate(world):
        for d, (composed, native) in res["composed"].items():
            assert np.array_equal(composed, native), (r, d)
            assert composed.shape[d] == WORLD * _inputs()["multi"][0].shape[d]


def test_group_over_two_mesh_axes(world):
    x = _inputs()["multi"][0]
    gathered, summed, names = world[0]["two_axes"]
    np.testing.assert_array_equal(gathered, np.concatenate([x + r for r in range(WORLD)], 0))
    np.testing.assert_allclose(summed, sum(x + r for r in range(WORLD)), rtol=1e-6)
    assert ("data", "model") in names.values()


#: a leaf's limit by the dtype on the wire: f32 sums of two at ``TOL``, a
#: bf16 or f16 wire at one unit in its last place
WIRE_RTOL = {"float32": TOL, "bfloat16": 2.0 ** -7, "float16": 2.0 ** -10}


@pytest.mark.parametrize("case", _collective_cases() + [("mean_replicated", None, "bf16")],
                         ids=lambda c: "-".join(str(x) for x in c))
def test_collective_helpers_match_the_reference(world, case):
    want, dtypes = _jax_collectives()
    for r, res in enumerate(world):
        got = res["collectives"]["got"][case]
        assert [d for d, _ in got] == dtypes, r
        for i, ((d, g), w) in enumerate(zip(got, want[case][r])):
            wire = "bfloat16" if case[2] == "bf16" else d
            rtol = max(WIRE_RTOL[wire], WIRE_RTOL[d])
            np.testing.assert_allclose(g, w, rtol=rtol, atol=rtol,
                                       err_msg=f"rank {r} leaf {i} ({d})")
            if wire == "bfloat16":   # what crossed the wire was bf16
                t = torch.from_numpy(g)
                assert torch.equal(t.to(torch.bfloat16).float(), t), (r, i)


def test_collective_helpers_reduce_over_the_pod_pairs(world):
    """Without the oracle: rank r's pod partner is r ^ 2, its model partner
    r ^ 1, so a sum over pods is its block plus the partner's."""
    stacked = _leaves_sorted(_tree_inputs())
    for r, res in enumerate(world):
        got = res["collectives"]["got"]
        for i, a in enumerate(stacked):
            pod = a[r] + a[r ^ 2]
            dt = got[("bucketed", BUCKETS[0], "none")][i][0]
            rtol = WIRE_RTOL[dt] * 4
            np.testing.assert_allclose(got[("bucketed", BUCKETS[0], "none")][i][1], pod,
                                       rtol=rtol, atol=rtol)
            np.testing.assert_allclose(got[("mean", None, "none")][i][1], pod / 2,
                                       rtol=rtol, atol=rtol)
            np.testing.assert_allclose(got[("psum_model", None, "none")][i][1], a[r] + a[r ^ 1],
                                       rtol=rtol, atol=rtol)
    # the small buckets are several, and some pack more than one dtype
    small = world[0]["collectives"]["buckets"][BUCKETS[0]]
    assert len(small) > 1 and any(len(d) > 1 for d in small)
    assert len(world[0]["collectives"]["buckets"][BUCKETS[1]]) == 1


def test_apply_op_takes_groups_from_the_mesh_in_scope(world):
    x = _inputs()["multi"][0]
    for r, res in enumerate(world):
        data, model = divmod(r, 2)
        got = res["scope"]
        np.testing.assert_allclose(got["model"], 2 * x + 2 * data + 2 * data + 1, rtol=1e-6)
        np.testing.assert_allclose(got["both"], 4 * x + sum(range(WORLD)), rtol=1e-6)
        np.testing.assert_array_equal(got["gather_data"],
                                      np.concatenate([x + model, x + (model + 2)], 1))


def test_elastic_reshard_round_trips(world):
    for res in world:
        rs = res["reshard"]
        assert rs["mesh"] == ((2, 2), ("data", "model"))
        assert rs["equal"] and rs["placements_match"]
        assert 0 < rs["sharded"] <= rs["leaves"]


# ------------------------------------------------- capture-only, fake world
@pytest.fixture
def fake_mesh():
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        yield init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


def test_sharded_lowering_under_a_fake_world(fake_mesh):
    from repro_torch import stitch

    mesh = fake_mesh
    f = stitch(_mlp_fn_on(mesh, 1), mesh=mesh, device="cpu", **MLP_SPECS)
    x, w1, w2 = (torch.from_numpy(a) for a in _inputs()["mlp"])
    low = f.lower(x, w1, w2)
    params = {p.name: p for p in low.module.parameters}
    assert [tuple(p.shape) for p in params.values()] == [(8, 16), (16, 16), (16, 16)]
    assert low._lowered.param_layouts == {"arg0": (None, None), "arg1": (None, ("model",)),
                                          "arg2": (("model",), None)}
    ar = [i for i in low.module.instructions if i.opcode == "all_reduce"]
    assert len(ar) == 1 and ar[0].attrs["axes"] == ("model",)
    assert f.options.mesh_axes == (("data", 2), ("model", 4))


def _mlp_fn_on(mesh, dim):
    def mlp(x, w1, w2):
        return torch.tanh(_fc().all_reduce(_gelu(x @ w1) @ w2, "sum", (mesh, dim)))
    return mlp


def test_unlowered_collective_raises_named_error(fake_mesh):
    from repro_torch import stitch
    from repro_torch.frontend import UnsupportedPrimitiveError

    mesh = fake_mesh

    def bad(x):
        return _fc().permute_tensor(x, [1, 2, 3, 0], (mesh, 1))

    f = stitch(bad, mesh=mesh, device="cpu", in_specs=(("model",),), out_specs=("model",))
    with pytest.raises(UnsupportedPrimitiveError, match="all_to_all_single"):
        f.lower(torch.zeros(16))


def test_stitch_mesh_argument_validation(fake_mesh):
    from repro_torch import stitch

    mesh = fake_mesh
    fn = _mlp_fn_on(mesh, 1)
    with pytest.raises(ValueError, match="in_specs"):
        stitch(fn, mesh=mesh)
    with pytest.raises(ValueError, match="mesh"):
        stitch(fn, in_specs=((),), out_specs=())
    with pytest.raises(ValueError, match="donate"):
        stitch(fn, mesh=mesh, donate_argnums=0, **MLP_SPECS)
    f = stitch(fn, mesh=mesh, device="cpu", **MLP_SPECS)
    with pytest.raises(ValueError, match="split"):
        f.lower(torch.zeros(8, 16), torch.zeros(16, 6), torch.zeros(6, 16))
