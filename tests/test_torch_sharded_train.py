"""The port's sharded train step (``make_sharded_train_step``, behind
``launch.train --mesh``), run by a world of four CPU gloo ranks on a
(data 2, model 2) mesh and held against the reference's own sharded step:
``jax.jit(make_train_step(...), in_shardings=(pshard, oshard, None),
out_shardings=(pshard, oshard, None), donate_argnums=(0, 1))`` under ``with
mesh:`` on four of the eight host devices ``tests/conftest.py`` forces.

The reference's ``launch/train.py --mesh`` builds its mesh with
``jax.make_mesh``, whose axes are ``Explicit`` under jax 0.9.0, and then its
embedding gather raises ``ShardingTypeError``; the oracle here is the same
jit on a ``jax.sharding.Mesh`` of ``Auto`` axes, where it runs (ROADMAP
queue 3).

One world serves the whole file: a module-scoped fixture writes the
reference's numpy params and the batches, spawns four ranks
(``torch.multiprocessing``, a ``FileStore``), each runs every case in
``_rank_main`` and pickles what it saw.  Cases: reduced qwen1.5-0.5b and
granite-moe-3b-a800m, f32, ``activation_sharding="sp"``, ``accum_steps`` 1
(each rank one row: cut over data, then model) and 2 (a microbatch of two
rows: cut over data, replicated over model), 3 steps, labels of -1 in
unequal numbers on the ranks' rows, and a clip that binds.  Then
``launch.train.main([... "--mesh", "2,2", "--device", "cpu"])`` in every
rank, and a rerun that resumes from its checkpoint.

Tolerances: losses and grad norms at rtol ``TRAJ_RTOL`` (1e-5); the params
at rtol 1e-5 and atol ``TRAJ_ATOL`` (1e-4, a tenth of the learning rate:
``tests/test_torch_train.py``'s trajectory bound, since AdamW turns a
near-zero gradient's last bits into a step of up to ``lr``); m and v at
rtol ``STATE_RTOL`` (1e-5) with an absolute floor of ``STATE_ATOL`` times
the leaf's largest magnitude, for the elements whose gradient is near zero.

This module imports only torch, numpy and pytest at the top, so a spawned
rank imports no jax.
"""
import contextlib
import datetime
import io
import os
import pickle

import numpy as np
import pytest
import torch

WORLD = 4
MESH = (2, 2)
ARCHS = ("qwen1.5-0.5b", "granite-moe-3b-a800m")
ACCUMS = (1, 2)
STEPS = 3
BATCH, SEQ = 4, 16
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10, grad_clip_norm=0.05)
TRAJ_RTOL, TRAJ_ATOL = 1e-5, 1e-4
STATE_RTOL, STATE_ATOL = 1e-5, 1e-5
#: labels set to -1 on each row: unequal counts on the ranks' rows
IGNORED = (0, 3, 7, 11)


def _case(arch, accum):
    return f"{arch}-accum{accum}"


def _batches(seed):
    """The global batches, from ``SyntheticLM`` of the port (the reference's
    entry for entry), with -1 labels: row r loses its first IGNORED[r]."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.data import SyntheticLM

    out = {}
    for arch in ARCHS:
        cfg = reduced_config(get_config(arch))
        it = SyntheticLM(cfg, SEQ, BATCH, seed=seed).iterate(0)
        bs = []
        for _ in range(STEPS):
            b = {k: np.array(v) for k, v in next(it).items()}
            for r, n in enumerate(IGNORED):
                b["labels"][r, :n] = -1
            bs.append(b)
        out[arch] = bs
    return out


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _rank_main(rank, outdir):
    import dataclasses

    import torch.distributed as dist

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.core.shard import block_cuts, local_block, spec_to_layout
    from repro_torch.distributed import params_shardings, reshard_state
    from repro_torch.launch import train as tlaunch
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.models import params_from_reference
    from repro_torch.train import (
        AdamWConfig, adamw_init, gather_tree, make_sharded_train_step,
    )

    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(outdir, "store"), WORLD),
                            rank=rank, world_size=WORLD, timeout=datetime.timedelta(seconds=120))
    mesh = make_smoke_mesh(*MESH, device="cpu")
    with open(os.path.join(outdir, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    res = {}
    for arch in ARCHS:
        cfg = dataclasses.replace(reduced_config(get_config(arch)), activation_sharding="sp")
        for accum in ACCUMS:
            params = params_from_reference(inputs["params"][arch], device="cpu")
            pshard = params_shardings(params, mesh)
            params, opt = reshard_state(params, adamw_init(params), mesh)
            step = make_sharded_train_step(cfg, AdamWConfig(**OPT), mesh, accum_steps=accum)
            metrics = []
            for b in inputs["batches"][arch]:
                params, opt, m = step(params, opt, b)
                metrics.append({k: float(v) for k, v in m.items()})
            full = {"params": gather_tree(params), "m": gather_tree(opt.m),
                    "v": gather_tree(opt.v)}
            blocks_ok = []
            for path, s in _flat(pshard).items():
                g = _flat(full["params"])[path]
                mine = _flat(params)[path].to_local()
                want = local_block(g, block_cuts(spec_to_layout(s.spec, g.ndim), mesh))
                blocks_ok.append((path, torch.equal(mine, want)))
            res[_case(arch, accum)] = dict(
                metrics=metrics, step=int(opt.step.to_local()), blocks_ok=blocks_ok,
                full={k: {p: t.numpy() for p, t in _flat(v).items()} for k, v in full.items()},
                specs={p: s.spec for p, s in _flat(pshard).items()})

    # the entry point, every rank: a run, then a rerun that resumes
    ck = os.path.join(outdir, "ck")
    writes = []
    real_savez = np.savez

    def counting_savez(*a, **kw):
        writes.append(a[0])
        return real_savez(*a, **kw)

    np.savez = counting_savez
    runs = []
    try:
        for steps in (2, 3):
            text = io.StringIO()
            with contextlib.redirect_stdout(text):
                rc = tlaunch.main(["--arch", "qwen1.5-0.5b", "--device", "cpu", "--mesh", "2,2",
                                   "--steps", str(steps), "--batch", "4", "--seq", "16",
                                   "--ckpt-dir", ck])
            runs.append((rc, text.getvalue()))
    finally:
        np.savez = real_savez
    res["launch"] = dict(runs=runs, writes=len(writes))
    with open(os.path.join(outdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    import jax
    import torch.multiprocessing as mp

    from repro.configs import get_config, reduced_config
    from repro.models import init_params

    outdir = str(tmp_path_factory.mktemp("sharded_train"))
    params = {a: jax.tree.map(np.asarray, init_params(reduced_config(get_config(a)), 0))
              for a in ARCHS}
    inputs = {"params": params, "batches": _batches(0)}
    with open(os.path.join(outdir, "inputs.pkl"), "wb") as f:
        pickle.dump(inputs, f)
    mp.spawn(_rank_main, args=(outdir,), nprocs=WORLD, join=True)
    out = []
    for r in range(WORLD):
        with open(os.path.join(outdir, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return inputs, out, os.path.join(outdir, "ck")


def _reference_trajectory(inputs, arch, accum):
    """The reference's sharded step (module docstring) from the same params
    on the same batches: each step's metrics, then the final params, m and
    v as numpy trees."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from repro.configs import get_config, reduced_config
    from repro.distributed.sharding import opt_state_shardings, params_shardings
    from repro.train import AdamWConfig, adamw_init, make_train_step

    cfg = dataclasses.replace(reduced_config(get_config(arch)), activation_sharding="sp")
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:WORLD]).reshape(MESH), ("data", "model"))
    params = jax.tree.map(jnp.asarray, inputs["params"][arch])
    pshard = params_shardings(params, mesh)
    params = jax.device_put(params, pshard)
    opt = adamw_init(params)
    oshard = opt_state_shardings(opt, pshard, mesh)
    step = jax.jit(make_train_step(cfg, AdamWConfig(**OPT), accum_steps=accum),
                   in_shardings=(pshard, oshard, None), out_shardings=(pshard, oshard, None),
                   donate_argnums=(0, 1))
    metrics = []
    with mesh:
        for b in inputs["batches"][arch]:
            params, opt, m = step(params, opt, {k: jnp.asarray(v) for k, v in b.items()})
            metrics.append({k: float(v) for k, v in m.items()})
    full = {"params": params, "m": opt.m, "v": opt.v}
    return metrics, {k: {p: np.asarray(t) for p, t in _flat(v).items()} for k, v in full.items()}


@pytest.mark.parametrize("accum", ACCUMS)
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_step_matches_the_reference_sharded_jit(world, arch, accum):
    inputs, ranks, _ = world
    want_metrics, want = _reference_trajectory(inputs, arch, accum)
    assert all(m["grad_norm"] > OPT["grad_clip_norm"] for m in want_metrics)   # the clip binds
    for res in ranks:
        got = res[_case(arch, accum)]
        assert got["step"] == STEPS
        for g, w in zip(got["metrics"], want_metrics, strict=True):
            for k in ("loss", "grad_norm", "lr"):
                np.testing.assert_allclose(g[k], w[k], rtol=TRAJ_RTOL, err_msg=k)
        for kind in ("params", "m", "v"):
            assert set(got["full"][kind]) == set(want[kind])
            for path, w in want[kind].items():
                g = got["full"][kind][path]
                atol = TRAJ_ATOL if kind == "params" else STATE_ATOL * float(np.abs(w).max())
                np.testing.assert_allclose(g, w, rtol=STATE_RTOL, atol=atol,
                                           err_msg=f"{kind} {path}")


@pytest.mark.parametrize("accum", ACCUMS)
@pytest.mark.parametrize("arch", ARCHS)
def test_blocks_at_rest_are_the_rules_cut_and_ranks_agree(world, arch, accum):
    _, ranks, _ = world
    first = ranks[0][_case(arch, accum)]
    assert any(s != (None,) * len(s) for s in first["specs"].values())
    for res in ranks:
        got = res[_case(arch, accum)]
        assert [p for p, ok in got["blocks_ok"] if not ok] == []
        for kind in ("params", "m", "v"):
            for path, a in got["full"][kind].items():
                np.testing.assert_array_equal(a, first["full"][kind][path])


def test_launch_train_mesh_runs_writes_on_rank_zero_and_resumes(world):
    _, ranks, ck = world
    from repro_torch.checkpoint import CheckpointManager

    for res in ranks:
        (rc1, out1), (rc2, out2) = res["launch"]["runs"]
        assert rc1 == 0 and rc2 == 0
    lead = ranks[0]["launch"]["runs"]
    assert "sharded over 2,2" in lead[0][1] and "done at step 2" in lead[0][1]
    # the rerun restored step 2 and ran one step: its first loss is its last
    line = [ln for ln in lead[1][1].splitlines() if "done at step 3" in ln][0]
    first, last = line.split("loss ")[1].split(" -> ")
    assert first == last
    assert ranks[0]["launch"]["writes"] == 6           # 3 files a save, 2 saves
    assert [r["launch"]["writes"] for r in ranks[1:]] == [0, 0, 0]
    assert all(r["launch"]["runs"][0][1] == "" for r in ranks[1:])
    assert CheckpointManager(ck).available_steps() == [2, 3]
