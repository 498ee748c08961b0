"""The port's checkpoints (``repro_torch.checkpoint``) and fault-tolerant
driver (``repro_torch.train.Trainer``) against the reference's, on the CPU:
the reference's layout (read both ways), round trip, keep-K, atomic
publish, async save, the restart that resumes bit for bit, the straggler
watchdog, and ``python -m repro_torch.launch.train``.

The port's ``Trainer`` is held against the reference's over the same steps
at rtol ``TRAJ_RTOL`` on each step's loss (measured: 1e-6)."""
import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as rckpt
from repro import train as rtrain
from repro.configs import get_config as rget
from repro.configs import reduced_config as rreduced
from repro.models import init_params as rinit_params
from repro_torch import train as ttrain
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, reduced_config
from repro_torch.core.ir import BFLOAT16
from repro_torch.data import SyntheticLM
from repro_torch.launch import train as tlaunch
from repro_torch.models import init_params, opt_state_from_reference, params_from_reference
from repro_torch.train.optimizer import tree_leaves_sorted

TRAJ_RTOL = 1e-5


def _model(dtype="float32"):
    cfg = reduced_config(get_config("qwen1.5-0.5b"), dtype=dtype)
    params = init_params(cfg, 0, device="cpu")
    opt = ttrain.adamw_init(params)
    opt.step.fill_(5)
    for t in tree_leaves_sorted(opt.m) + tree_leaves_sorted(opt.v):
        t.normal_()
    return cfg, params, opt


def _same(a_tree, b_tree):
    a, b = tree_leaves_sorted(a_tree), tree_leaves_sorted(b_tree)
    assert len(a) == len(b)
    for x, y in zip(a, b, strict=True):
        assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoint_roundtrip(tmp_path, dtype):
    _, params, opt = _model(dtype)
    mgr = CheckpointManager(str(tmp_path / "c"), keep=2)
    path = mgr.save(3, params, opt)
    assert sorted(os.listdir(path)) == ["META", "opt_m.npz", "opt_v.npz", "params.npz"]
    with open(os.path.join(path, "META")) as f:
        assert json.load(f) == {"step": 3, "opt_step": 5}
    p2, o2, step = mgr.restore(3, params, opt)
    assert step == 3 and int(o2.step) == 5 and o2.step.dtype == torch.int32
    _same(params, p2)
    _same(opt.m, o2.m)
    _same(opt.v, o2.v)


def test_bf16_leaves_are_written_by_their_bits(tmp_path):
    _, params, opt = _model("bfloat16")
    path = CheckpointManager(str(tmp_path / "c")).save(1, params, opt)
    with np.load(os.path.join(path, "params.npz")) as npz:
        tok = npz["/embed/tok"]
        gamma = npz["/ln_f/gamma"]
    assert tok.dtype == BFLOAT16 and gamma.dtype == np.float32
    bits = params["embed"]["tok"].view(torch.int16).numpy().view(np.uint16)
    np.testing.assert_array_equal(tok.view(np.uint16), bits)


def test_keep_k_garbage_collection(tmp_path):
    _, params, opt = _model()
    mgr = CheckpointManager(str(tmp_path / "c"), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, params, opt)
    assert mgr.available_steps() == [3, 4]


def test_atomic_publish_no_partial_checkpoints(tmp_path):
    _, params, opt = _model()
    mgr = CheckpointManager(str(tmp_path / "c"), keep=3)
    mgr.save(1, params, opt)
    # a stale tmp dir (a crash mid-write) and a step without META stay unseen
    os.makedirs(str(tmp_path / "c" / ".tmp_step_9"), exist_ok=True)
    os.makedirs(str(tmp_path / "c" / "step_8"), exist_ok=True)
    assert mgr.available_steps() == [1]
    assert mgr.restore_latest(params, opt)[2] == 1
    with pytest.raises(ValueError, match="template"):
        mgr.restore_latest()
    assert CheckpointManager(str(tmp_path / "empty")).restore_latest(params, opt) is None


def test_async_save_copies_before_returning(tmp_path):
    """The host copy is taken at ``save``: updating the params in place
    right after does not reach the checkpoint."""
    _, params, opt = _model()
    want = {k: v.clone() for k, v in params["embed"].items()}
    mgr = CheckpointManager(str(tmp_path / "c"), async_save=True)
    mgr.save(2, params, opt)
    params["embed"]["tok"].add_(1.0)
    mgr.wait()
    p2, _, _ = mgr.restore(2, params, opt)
    assert torch.equal(p2["embed"]["tok"], want["tok"])


def test_reads_a_reference_checkpoint(tmp_path):
    """A checkpoint the reference writes for an f32 config restores in the
    port to the same values, bf16 leaves (written as 2-byte voids) too."""
    cfg = rreduced(rget("qwen1.5-0.5b"))
    params = rinit_params(cfg, 0)
    opt = rtrain.adamw_init(params)
    opt = rtrain.AdamWState(jnp.asarray(7, jnp.int32),
                            jax.tree.map(lambda a: a + 0.5, opt.m), opt.v)
    rckpt.CheckpointManager(str(tmp_path / "r")).save(7, params, opt)
    tparams = params_from_reference(jax.tree.map(np.asarray, params), device="cpu")
    topt = ttrain.adamw_init(tparams)
    p2, o2, step = CheckpointManager(str(tmp_path / "r")).restore_latest(tparams, topt)
    assert step == 7 and int(o2.step) == 7
    _same(tparams, p2)
    for a, b in zip(jax.tree.leaves(opt.m), tree_leaves_sorted(o2.m), strict=True):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    bf = {"w": jnp.asarray([[1.5, -2.25]], jnp.bfloat16)}
    rckpt.CheckpointManager(str(tmp_path / "b")).save(1, bf, rtrain.adamw_init(bf))
    like = {"w": torch.zeros((1, 2), dtype=torch.bfloat16)}
    got, _, _ = CheckpointManager(str(tmp_path / "b")).restore(1, like, ttrain.adamw_init(like))
    assert got["w"].dtype == torch.bfloat16 and got["w"].tolist() == [[1.5, -2.25]]


def test_the_reference_reads_a_port_checkpoint(tmp_path):
    cfg, params, opt = _model()
    CheckpointManager(str(tmp_path / "c")).save(4, params, opt)
    rparams = rinit_params(rreduced(rget("qwen1.5-0.5b")), 1)
    p2, o2, step = rckpt.CheckpointManager(str(tmp_path / "c")).restore(
        4, rparams, rtrain.adamw_init(rparams))
    assert step == 4 and int(o2.step) == 5
    for a, b in zip(jax.tree.leaves(p2), tree_leaves_sorted(params), strict=True):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


# ------------------------------------------------------------------ the driver
def _mk_trainer(path, cfg, total_steps=12, injector=None, ckpt_every=4):
    ocfg = ttrain.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=total_steps)
    tcfg = ttrain.TrainerConfig(total_steps=total_steps, checkpoint_every=ckpt_every,
                                keep_checkpoints=2)
    ckpt = CheckpointManager(str(path), keep=2)

    def data_factory(start):
        return SyntheticLM(cfg, 16, 4, seed=7).iterate(start)

    return ttrain.Trainer(cfg, ocfg, tcfg, data_factory, ckpt, failure_injector=injector,
                          device="cpu")


def test_restart_resumes_bit_exact(tmp_path):
    """Kill training at step 6; a fresh Trainer restores the step-4
    checkpoint and the data cursor, and ends bit for bit where an
    uninterrupted run ends."""
    cfg = reduced_config(get_config("qwen1.5-0.5b"))

    def fresh():
        return init_params(cfg, 0, device="cpu")

    t_ref = _mk_trainer(tmp_path / "ref", cfg)
    p_ref, o_ref, _ = t_ref.run(fresh())
    inj = ttrain.FailureInjector(fail_at_steps=[6])
    t1 = _mk_trainer(tmp_path / "x", cfg, injector=inj)
    with pytest.raises(RuntimeError, match="injected failure at step 6"):
        t1.run(fresh())
    assert CheckpointManager(str(tmp_path / "x")).available_steps() == [4]
    t2 = _mk_trainer(tmp_path / "x", cfg)
    p2, o2, step = t2.run(fresh())
    assert step == 12 and [h["step"] for h in t2.history] == list(range(4, 12))
    _same(p_ref, p2)
    _same(o_ref.m, o2.m)
    assert int(o2.step) == int(o_ref.step) == 12
    assert [h["loss"] for h in t2.history] == [h["loss"] for h in t_ref.history][4:]


def test_trainer_follows_the_reference_trainer(tmp_path):
    """The port's ``Trainer`` (eager on the CPU) and the reference's
    (``jax.jit`` with donation) from the same params: every step's loss,
    and the checkpoints they keep."""
    rcfg = rreduced(rget("granite-moe-3b-a800m"))
    tcfg = reduced_config(get_config("granite-moe-3b-a800m"))
    params = jax.tree.map(np.asarray, rinit_params(rcfg, 0))
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=8)
    tc = dict(total_steps=8, checkpoint_every=4, keep_checkpoints=2)
    ref = rtrain.Trainer(rcfg, rtrain.AdamWConfig(**kw), rtrain.TrainerConfig(**tc),
                         lambda s: SyntheticLM(rcfg, 16, 4, seed=2).iterate(s),
                         rckpt.CheckpointManager(str(tmp_path / "r"), keep=2))
    ref.run(jax.tree.map(jnp.asarray, params))
    port = ttrain.Trainer(tcfg, ttrain.AdamWConfig(**kw), ttrain.TrainerConfig(**tc),
                          lambda s: SyntheticLM(tcfg, 16, 4, seed=2).iterate(s),
                          CheckpointManager(str(tmp_path / "t"), keep=2), device="cpu")
    port.run(params_from_reference(params, device="cpu"))
    np.testing.assert_allclose([h["loss"] for h in port.history],
                               [h["loss"] for h in ref.history], rtol=TRAJ_RTOL)
    assert port.ckpt.available_steps() == ref.ckpt.available_steps() == [4, 8]


def test_trainer_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = reduced_config(get_config("qwen1.5-0.5b"))
    with pytest.raises(RuntimeError, match="is_available"):
        ttrain.Trainer(cfg, ttrain.AdamWConfig(), ttrain.TrainerConfig(), lambda s: iter(()))


def test_straggler_watchdog_flags_the_reference_steps():
    rng = np.random.RandomState(0)
    times = list(rng.uniform(0.09, 0.11, 60))
    for i, t in ((10, 0.5), (23, 0.35), (24, 0.4), (41, 1.2), (55, 0.33)):
        times[i] = t
    times[30] = 0.29                             # under 3x the median: not flagged
    ref, port = rtrain.StragglerWatchdog(3.0, window=20), ttrain.StragglerWatchdog(3.0, window=20)
    got = [port.observe(i, t) for i, t in enumerate(times)]
    want = [ref.observe(i, t) for i, t in enumerate(times)]
    assert got == want and port.flagged == ref.flagged
    assert [s for s, _, _ in port.flagged] == [10, 23, 24, 41, 55]


def test_failure_injector_fires_once():
    inj = ttrain.FailureInjector(fail_at_steps=[2])
    inj.maybe_fail(1)
    with pytest.raises(RuntimeError, match="step 2"):
        inj.maybe_fail(2)
    inj.maybe_fail(2)


# ------------------------------------------------------------- the entry point
def test_launch_train_on_the_cpu(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    rc = tlaunch.main(["--arch", "granite-moe-3b-a800m", "--device", "cpu", "--reduced",
                       "--steps", "4", "--batch", "4", "--seq", "16", "--ckpt-dir", ck])
    out = capsys.readouterr().out
    assert rc == 0 and "done at step 4" in out and "reduced config" in out
    assert CheckpointManager(ck).available_steps() == [4]
    # a rerun resumes from the checkpoint: nothing left to do
    assert tlaunch.main(["--arch", "granite-moe-3b-a800m", "--device", "cpu", "--steps", "4",
                         "--batch", "4", "--seq", "16", "--ckpt-dir", ck]) == 0
    assert "done at step" not in capsys.readouterr().out


def test_launch_train_mesh_raises_naming_the_sharding_item(tmp_path):
    """Kept under its old name: ``--mesh 2,2`` with no ``torch.distributed``
    world raises, naming the 4 ranks it needs (``tests/test_torch_sharded_train.py``
    runs it in a world of four)."""
    with pytest.raises(RuntimeError, match=re.escape("needs a world of 4 ranks")):
        tlaunch.main(["--arch", "qwen1.5-0.5b", "--device", "cpu", "--mesh", "2,2",
                      "--ckpt-dir", str(tmp_path)])


def test_launch_train_defaults_to_the_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        tlaunch.main(["--arch", "qwen1.5-0.5b", "--ckpt-dir", str(tmp_path)])


def test_opt_state_carried_from_the_reference_restores(tmp_path):
    """``opt_state_from_reference`` then save and restore: the reference's
    state survives the port's checkpoint unchanged."""
    rparams = rinit_params(rreduced(rget("mamba2-1.3b")), 0)
    rstate = rtrain.adamw_init(rparams)
    rstate = rtrain.AdamWState(jnp.asarray(2, jnp.int32),
                               jax.tree.map(lambda a: a + 1.0, rstate.m), rstate.v)
    tparams = params_from_reference(jax.tree.map(np.asarray, rparams), device="cpu")
    tstate = opt_state_from_reference(jax.tree.map(np.asarray, rstate), device="cpu")
    mgr = CheckpointManager(str(tmp_path / "c"))
    mgr.save(2, tparams, tstate)
    _, o2, _ = mgr.restore(2, tparams, tstate)
    assert int(o2.step) == 2
    for a, b in zip(jax.tree.leaves(rstate.m), tree_leaves_sorted(o2.m), strict=True):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
