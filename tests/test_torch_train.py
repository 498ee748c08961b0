"""The port's training (``repro_torch.train``) against the reference's
(``repro.train``) on the CPU, on the same numpy params and batches, f32.

Tolerances, each measured before it was set (the port's sums and products
run in another order than XLA's, and torch's ``cos``/``pow`` may round an
f32 ulp apart from jnp's):

* the schedule: ``lr_at`` at rtol 1e-6 (measured: 1 ulp);
* one ``adamw_update`` in f32 at rtol = atol = 1e-6; in bf16 within one
  bf16 ulp of the reference's parameter;
* the loss and every gradient leaf at ``GRAD_RTOL``/``GRAD_ATOL`` (measured
  across the ten families: |dloss| <= 1e-6, |dgrad| <= 3.4e-6);
* the 10-step trajectories: each step's loss and grad norm at rtol
  ``TRAJ_RTOL`` and the params after each step at atol ``TRAJ_ATOL``
  (measured: 1e-6 on the loss, 7e-6 on the params);
* the stitched step's 20 steps: loss, grad norm and params at
  ``STITCH_TOL`` (measured: 2.4e-7 and 1.5e-8);
* ``accum_steps=4`` against 1 at the reference's rtol 2e-3, atol 2e-4;
* remat and replay against their plain runs: bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import train as rtrain
from repro.configs import get_config as rget
from repro.configs import reduced_config as rreduced
from repro.data import SyntheticLM
from repro.models import init_params as rinit_params
from repro.train import compression as rcomp
from repro.train import optimizer as ropt
from repro_torch import StitchOptions
from repro_torch import train as ttrain
from repro_torch.configs import get_config, reduced_config
from repro_torch.core import executor
from repro_torch.models import opt_state_from_reference, params_from_reference
from repro_torch.models.module import tree_map
from repro_torch.train import compression as tcomp
from repro_torch.train import optimizer as topt
from repro_torch.train.optimizer import tree_leaves_sorted

GRAD_RTOL, GRAD_ATOL = 1e-3, 1e-5
TRAJ_RTOL, TRAJ_ATOL = 1e-5, 1e-4
STITCH_TOL = 1e-6


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _pair(arch, **over):
    """(reference config, port config, the reference's seeded params as numpy)."""
    cfg = rreduced(rget(arch), **over)
    tcfg = reduced_config(get_config(arch), **over)
    return cfg, tcfg, jax.tree.map(np.asarray, rinit_params(cfg, 0))


def _port(tree):
    return params_from_reference(tree, device="cpu")


def _close_trees(ref, port, rtol, atol):
    ref_leaves, port_leaves = jax.tree.leaves(ref), tree_leaves_sorted(port)
    assert len(ref_leaves) == len(port_leaves)
    for a, b in zip(ref_leaves, port_leaves, strict=True):
        np.testing.assert_allclose(_np(b), np.asarray(a), rtol=rtol, atol=atol)


# ------------------------------------------------------------------ optimizer
@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_lr_schedule_matches_the_reference(schedule):
    kw = dict(lr=1e-3, warmup_steps=10, total_steps=110, schedule=schedule)
    for step in [0, 1, 5, 9, 10, 11, 50, 109, 110, 200]:
        want = float(ropt.lr_at(ropt.AdamWConfig(**kw), step))
        for s in (step, torch.tensor(step, dtype=torch.int32)):
            got = topt.lr_at(topt.AdamWConfig(**kw), s)
            assert got.dtype == torch.float32
            np.testing.assert_allclose(float(got), want, rtol=1e-6)


def test_lr_schedule_shapes():
    cfg = topt.AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=110, schedule="cosine")
    assert float(topt.lr_at(cfg, 0)) < 1e-3 * 0.2
    assert abs(float(topt.lr_at(cfg, 10)) - 1e-3) < 1e-6
    assert float(topt.lr_at(cfg, 110)) <= 1e-3 * cfg.min_lr_ratio + 1e-9


def _random_tree(rng, dtype=np.float32):
    return {"w": rng.randn(16, 8).astype(dtype), "b": rng.randn(8).astype(dtype),
            "blk": {"k": rng.randn(3, 4, 5).astype(dtype)}}


@pytest.mark.parametrize("clip", [1.0, 100.0])
def test_adamw_update_f32_matches_the_reference(clip):
    """One update from a state three steps in, clipped and not."""
    rng = np.random.RandomState(0)
    params, grads = _random_tree(rng), _random_tree(rng)
    m = jax.tree.map(lambda a: (a * 0.1).astype(np.float32), _random_tree(rng))
    v = jax.tree.map(lambda a: np.abs(a).astype(np.float32) * 0.01, _random_tree(rng))
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=20, grad_clip_norm=clip)
    rstate = ropt.AdamWState(jnp.asarray(3, jnp.int32), m, v)
    rp, rs, rm = ropt.adamw_update(ropt.AdamWConfig(**kw), params, grads, rstate)
    tstate = opt_state_from_reference(rstate, device="cpu")
    tp_in = _port(params)
    tp, ts, tm = topt.adamw_update(topt.AdamWConfig(**kw), tp_in, _port(grads), tstate)
    _close_trees(rp, tp, 1e-6, 1e-6)
    _close_trees(rs.m, ts.m, 1e-6, 1e-6)
    _close_trees(rs.v, ts.v, 1e-6, 1e-6)
    assert int(ts.step) == int(rs.step) == 4 and ts.step.dtype == torch.int32
    np.testing.assert_allclose(float(tm["grad_norm"]), float(rm["grad_norm"]), rtol=1e-6)
    np.testing.assert_allclose(float(tm["lr"]), float(rm["lr"]), rtol=1e-6)
    # the functional form leaves its inputs be; the in-place form writes them
    _close_trees(params, tp_in, 0, 0)
    assert int(tstate.step) == 3
    tp2, ts2, _ = topt.adamw_update_(topt.AdamWConfig(**kw), tp_in, _port(grads), tstate)
    assert tp2 is tp_in and ts2 is tstate and int(tstate.step) == 4
    for a, b in zip(tree_leaves_sorted(tp), tree_leaves_sorted(tp_in), strict=True):
        assert torch.equal(a, b)


def test_adamw_update_bf16_within_one_ulp():
    """bf16 params, f32 state: the new params within one bf16 ulp of the
    reference's (both round the same f32 value, which may differ by an f32
    ulp, to bf16)."""
    rng = np.random.RandomState(1)
    params32, grads = _random_tree(rng), _random_tree(rng)
    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), params32)
    cfg = dict(lr=3e-2, warmup_steps=1, total_steps=10)
    rp, _, _ = ropt.adamw_update(ropt.AdamWConfig(**cfg), params, grads,
                                 ropt.adamw_init(params))
    tparams = _port(jax.tree.map(np.asarray, params))
    tp, _, _ = topt.adamw_update(topt.AdamWConfig(**cfg), tparams, _port(grads),
                                 topt.adamw_init(tparams))
    for a, b in zip(jax.tree.leaves(rp), tree_leaves_sorted(tp), strict=True):
        assert b.dtype == torch.bfloat16
        want = np.asarray(a, np.float32)
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
        assert np.all(np.abs(b.float().numpy() - want) <= ulp)


def test_adamw_converges_quadratic():
    target = torch.tensor([1.0, -2.0, 3.0])
    params = {"w": torch.zeros((3, 1))}
    cfg = topt.AdamWConfig(lr=5e-2, weight_decay=0.0, warmup_steps=1, total_steps=500,
                           schedule="constant")
    state = topt.adamw_init(params)
    for _ in range(300):
        p = params["w"].detach().requires_grad_()
        loss = torch.sum((p[:, 0] - target) ** 2)
        (g,) = torch.autograd.grad(loss, [p])
        params, state, _ = topt.adamw_update(cfg, params, {"w": g}, state)
    assert float(torch.sum((params["w"][:, 0] - target) ** 2)) < 1e-3


def test_clip_and_global_norm_match_the_reference():
    rng = np.random.RandomState(2)
    tree = jax.tree.map(lambda a: a * 30, _random_tree(rng))
    rc, rn = ropt.clip_by_global_norm(tree, 1.0)
    tc, tn = topt.clip_by_global_norm(_port(tree), 1.0)
    np.testing.assert_allclose(float(tn), float(rn), rtol=1e-6)
    _close_trees(rc, tc, 1e-6, 1e-7)
    np.testing.assert_allclose(float(topt.global_norm(tc)), 1.0, rtol=1e-5)
    np.testing.assert_allclose(float(topt.global_norm(_port(tree))),
                               float(ropt.global_norm(tree)), rtol=1e-6)
    small = {"a": torch.full((10,), 1e-3)}
    same, _ = topt.clip_by_global_norm(small, 1.0)
    assert torch.equal(same["a"], small["a"])


def test_init_and_specs():
    params = {"w": torch.zeros((4, 3), dtype=torch.bfloat16), "b": torch.zeros(3)}
    st = topt.adamw_init(params)
    assert st.step.shape == () and st.step.dtype == torch.int32
    assert st.m["w"].dtype == torch.float32 and st.v["w"].shape == (4, 3)
    sp = topt.adamw_init_specs({k: v.to("meta") for k, v in params.items()})
    assert sp.m["w"].device.type == "meta" and sp.step.dtype == torch.int32


# ---------------------------------------------------------------- compression
def test_int8_error_feedback_matches_the_reference():
    rng = np.random.RandomState(0)
    g = {"w": rng.randn(64, 64).astype("f4"), "b": rng.randn(64).astype("f4")}
    rw, rd, rs = rcomp.compress_int8_ef(g, rcomp.ef_init(g))
    tw, td, ts = tcomp.compress_int8_ef(_port(g), tcomp.ef_init(_port(g)))
    for k in g:
        assert tw[k][0].dtype == torch.int8
        np.testing.assert_array_equal(_np(tw[k][0]), np.asarray(rw[k][0]))   # q exactly
        np.testing.assert_allclose(float(tw[k][1]), float(rw[k][1]), rtol=1e-7)
    _close_trees(rd, td, 1e-6, 1e-7)
    _close_trees(rs.residual, ts.residual, 1e-5, 1e-7)
    assert tcomp.wire_bytes(tw) == rcomp.wire_bytes(rw)
    assert tcomp.wire_bytes({"w": tw["w"][0]}) * 4 == tcomp.wire_bytes({"w": _port(g)["w"]})


def test_error_feedback_compensates_bias():
    rng = np.random.RandomState(0)
    true_sum = np.zeros(32, np.float32)
    applied = np.zeros(32, np.float32)
    st = tcomp.ef_init({"w": torch.zeros(32)})
    for _ in range(50):
        g = {"w": torch.tensor(rng.randn(32).astype("f4") * 0.1)}
        true_sum += g["w"].numpy()
        _, deq, st = tcomp.compress_int8_ef(g, st)
        applied += deq["w"].numpy()
    np.testing.assert_allclose(applied + st.residual["w"].numpy(), true_sum, rtol=1e-4, atol=1e-4)


def test_bf16_compress_halves_bytes():
    g = {"w": torch.zeros((128, 128))}
    assert tcomp.wire_bytes(tcomp.bf16_compress(g)) * 2 == tcomp.wire_bytes(g)
    assert tcomp.bf16_decompress(tcomp.bf16_compress(g))["w"].dtype == torch.float32


# ---------------------------------------------------------------------- losses
def test_cross_entropy_masks_padded_vocab_and_labels():
    rng = np.random.RandomState(3)
    logits = (rng.randn(2, 5, 16) * 3).astype(np.float32)
    labels = rng.randint(-1, 11, (2, 5)).astype(np.int32)
    want = float(rtrain.cross_entropy(jnp.asarray(logits), jnp.asarray(labels), 11))
    got = float(ttrain.cross_entropy(torch.tensor(logits), torch.tensor(labels), 11))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    uniform = ttrain.cross_entropy(torch.zeros((1, 3, 8)), torch.tensor([[1, 2, -1]]), 5)
    assert abs(float(uniform) - np.log(5)) < 1e-5
    none = ttrain.cross_entropy(torch.zeros((1, 2, 8)), torch.tensor([[-1, -1]]), 5)
    assert float(none) == 0.0


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "granite-moe-3b-a800m"])
def test_chunked_loss_equals_the_unchunked_one(arch):
    _, tcfg, params = _pair(arch)
    batch = SyntheticLM(tcfg, 32, 2, seed=4).batch_at(0)
    p = _port(params)
    whole = ttrain.value_and_grad(ttrain.make_loss_fn(dataclasses.replace(tcfg, loss_chunk=32)),
                                  p, batch)
    chunked = ttrain.value_and_grad(ttrain.make_loss_fn(dataclasses.replace(tcfg, loss_chunk=8)),
                                    p, batch)
    np.testing.assert_allclose(float(chunked[0]), float(whole[0]), rtol=1e-6)
    for a, b in zip(tree_leaves_sorted(whole[1]), tree_leaves_sorted(chunked[1]), strict=True):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("arch,over", [
    ("qwen1.5-0.5b", {}),
    ("qwen1.5-0.5b", {"loss_chunk": 8}),
    ("granite-moe-3b-a800m", {}),
    ("granite-moe-3b-a800m", {"moe_impl": "scatter"}),
    ("hymba-1.5b", {}),
    ("mamba2-1.3b", {}),
    ("qwen2-vl-2b", {}),
    ("whisper-base", {}),
], ids=lambda v: v if isinstance(v, str) else "-".join(f"{k}={x}" for k, x in v.items()) or "default")
def test_loss_gradients_match_jax_value_and_grad(arch, over):
    """``value_and_grad(make_loss_fn)``: the loss and every leaf's gradient
    against ``jax.value_and_grad`` of the reference's loss."""
    cfg, tcfg, params = _pair(arch, **over)
    batch = SyntheticLM(cfg, 16, 2, seed=1).batch_at(0)
    rl, rg = jax.jit(jax.value_and_grad(rtrain.make_loss_fn(cfg)))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    tl, tg = ttrain.value_and_grad(ttrain.make_loss_fn(tcfg), _port(params), batch)
    np.testing.assert_allclose(float(tl), float(rl), rtol=1e-6)
    _close_trees(rg, tg, GRAD_RTOL, GRAD_ATOL)


# ------------------------------------------------------------------- the steps
@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "granite-moe-3b-a800m"])
def test_ten_steps_follow_the_jitted_reference(arch):
    """The port's ``make_train_step`` against ``jax.jit(repro.train.
    make_train_step)`` over 10 steps from the same params and batches."""
    cfg, tcfg, params = _pair(arch)
    oc = dict(lr=1e-3, warmup_steps=2, total_steps=10)
    ref = jax.jit(rtrain.make_train_step(cfg, ropt.AdamWConfig(**oc)))
    step = ttrain.make_train_step(tcfg, topt.AdamWConfig(**oc))
    rp, ro = jax.tree.map(jnp.asarray, params), None
    ro = ropt.adamw_init(rp)
    tp = _port(params)
    to = topt.adamw_init(tp)
    data = SyntheticLM(cfg, 16, 4, seed=0)
    for i in range(10):
        batch = data.batch_at(i)
        rp, ro, rm = ref(rp, ro, {k: jnp.asarray(v) for k, v in batch.items()})
        tp2, to2, tm = step(tp, to, batch)
        assert tp2 is tp and to2 is to                 # donated: written in place
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(rm[k]), rtol=TRAJ_RTOL,
                                       err_msg=f"step {i} {k}")
        _close_trees(rp, tp, 0, TRAJ_ATOL)
    assert int(to.step) == 10


def test_grad_accumulation_matches_full_batch():
    _, tcfg, params = _pair("qwen1.5-0.5b")
    ocfg = topt.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    batch = SyntheticLM(tcfg, 16, 8, seed=1).batch_at(0)
    p1, p4 = _port(params), _port(params)
    _, _, m1 = ttrain.make_train_step(tcfg, ocfg, accum_steps=1)(p1, topt.adamw_init(p1), batch)
    _, _, m4 = ttrain.make_train_step(tcfg, ocfg, accum_steps=4)(p4, topt.adamw_init(p4), batch)
    assert abs(float(m1["loss"]) - float(m4["loss"])) < 1e-4
    for a, b in zip(tree_leaves_sorted(p1), tree_leaves_sorted(p4), strict=True):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=2e-3, atol=2e-4)


def test_grad_accumulation_matches_the_reference():
    cfg, tcfg, params = _pair("granite-moe-3b-a800m")
    oc = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    batch = SyntheticLM(cfg, 16, 8, seed=1).batch_at(0)
    rp = jax.tree.map(jnp.asarray, params)
    rp, _, rm = jax.jit(rtrain.make_train_step(cfg, ropt.AdamWConfig(**oc), accum_steps=4))(
        rp, ropt.adamw_init(rp), {k: jnp.asarray(v) for k, v in batch.items()})
    tp = _port(params)
    _, _, tm = ttrain.make_train_step(tcfg, topt.AdamWConfig(**oc), accum_steps=4)(
        tp, topt.adamw_init(tp), batch)
    np.testing.assert_allclose(float(tm["loss"]), float(rm["loss"]), rtol=TRAJ_RTOL)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(rm["grad_norm"]), rtol=TRAJ_RTOL)
    _close_trees(rp, tp, 0, TRAJ_ATOL)


def test_loss_decreases_on_tiny_model():
    _, tcfg, params = _pair("qwen1.5-0.5b")
    p = _port(params)
    o = topt.adamw_init(p)
    step = ttrain.make_train_step(
        tcfg, topt.AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=60, schedule="constant"))
    data = SyntheticLM(tcfg, seq_len=32, global_batch=8, seed=0)
    losses = [float(step(p, o, data.batch_at(i))[2]["loss"]) for i in range(40)]
    assert losses[-1] < losses[0] * 0.8, losses[::8]


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "granite-moe-3b-a800m", "hymba-1.5b",
                                  "whisper-base"])
@pytest.mark.parametrize("remat", ["full", "dots", "selective"])
def test_remat_changes_no_value(arch, remat):
    """``cfg.remat`` against ``none``: the loss and every gradient bit for
    bit on the CPU."""
    _, tcfg, params = _pair(arch)
    batch = SyntheticLM(tcfg, 16, 2, seed=2).batch_at(0)
    base = ttrain.value_and_grad(ttrain.make_loss_fn(tcfg), _port(params), batch)
    got = ttrain.value_and_grad(ttrain.make_loss_fn(dataclasses.replace(tcfg, remat=remat)),
                                _port(params), batch)
    assert torch.equal(got[0], base[0])
    for a, b in zip(tree_leaves_sorted(base[1]), tree_leaves_sorted(got[1]), strict=True):
        assert torch.equal(a, b)


def test_full_remat_keeps_fewer_tensors_for_backward():
    """What autograd packs outside the checkpointed layers: with ``full``
    remat a layer keeps only its input, so far fewer bytes are held."""
    _, tcfg, params = _pair("qwen1.5-0.5b")
    batch = SyntheticLM(tcfg, 16, 2, seed=2).batch_at(0)

    def saved_bytes(remat):
        total = [0]

        def pack(t):
            total[0] += t.numel() * t.element_size()
            return t

        loss_fn = ttrain.make_loss_fn(dataclasses.replace(tcfg, remat=remat))
        tree, _ = ttrain.trainer._grad_leaves(_port(params))
        with torch.enable_grad(), torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            loss_fn(tree, batch)
        return total[0]

    assert saved_bytes("full") < saved_bytes("none") / 2


# ---------------------------------------------------------- the captured step
class _StandInGraph:
    """What a captured CUDA graph does, on the CPU: its capture runs nothing,
    and each ``replay`` runs the captured step again."""

    def __init__(self, run):
        self.run, self.instantiated = run, False

    def instantiate(self):
        self.instantiated = True

    def replay(self):
        assert self.instantiated
        self.run()


@pytest.fixture
def stand_in(monkeypatch):
    captures = []

    def capture(run, device, keep_graph=False):
        assert keep_graph
        captures.append(_StandInGraph(run))
        return captures[-1], None

    monkeypatch.setattr(executor, "_need_card", lambda device: torch.device(device))
    monkeypatch.setattr(executor, "_warm_up", lambda run, device: run())
    monkeypatch.setattr(executor, "_capture_graph", capture)
    return captures


def test_captured_step_replays_the_eager_steps(stand_in):
    """``CapturedTrainStep`` through a stand-in graph: the first call is the
    eager warm-up step, the rest replay; the trajectory is the eager
    step's bit for bit, metrics included, and one capture is made."""
    _, tcfg, params = _pair("granite-moe-3b-a800m")
    oc = topt.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=6)
    data = SyntheticLM(tcfg, 16, 2, seed=5)
    pe, pg = _port(params), _port(params)
    oe, og = topt.adamw_init(pe), topt.adamw_init(pg)
    eager = ttrain.make_train_step(tcfg, oc)
    graphed = ttrain.CapturedTrainStep(ttrain.make_train_step(tcfg, oc), device="cpu")
    for i in range(6):
        _, _, me = eager(pe, oe, data.batch_at(i))
        pg, og, mg = graphed(pg, og, data.batch_at(i))
        for k in me:
            assert torch.equal(me[k], mg[k]), (i, k)
    for a, b in zip(tree_leaves_sorted(pe), tree_leaves_sorted(pg), strict=True):
        assert torch.equal(a, b)
    assert int(og.step) == 6 and len(stand_in) == 1
    assert graphed.stats()["replays"] == 5 and graphed.stats()["capture_s"] is not None
    with pytest.raises(ValueError, match="captured with"):
        graphed(_port(params), og, data.batch_at(0))


def test_captured_step_needs_the_card():
    with pytest.raises(RuntimeError, match="runs on the card"):
        ttrain.CapturedTrainStep(lambda *a: a, device="cpu")


# ----------------------------------------------------------- the stitched step
BATCH, D_IN, D_H, D_OUT = 64, 16, 32, 8


def _mlp_params(rng):
    return {"w1": rng.normal(size=(D_IN, D_H), scale=0.1).astype(np.float32),
            "b1": np.zeros((D_H,), np.float32),
            "w2": rng.normal(size=(D_H, D_OUT), scale=0.1).astype(np.float32),
            "b2": np.zeros((D_OUT,), np.float32)}


def _ref_mlp_loss(params, batch):
    x, y = batch
    h = jnp.tanh(x @ params["w1"] + params["b1"])
    return jnp.mean((h @ params["w2"] + params["b2"] - y) ** 2)


def _mlp_loss(params, batch):
    x, y = batch
    h = torch.tanh(x @ params["w1"] + params["b1"])
    return torch.mean((h @ params["w2"] + params["b2"] - y) ** 2)


@pytest.fixture
def replay_stand_in(monkeypatch):
    """Every plan call through its CUDA-graph replay, on the CPU: the
    stand-in's capture runs the steps once, each replay runs them again."""
    class Graph:
        def __init__(self, run, outs):
            self.run, self.outs = run, outs

        def replay(self):
            for o, n in zip(self.outs, self.run(), strict=True):
                o.copy_(n)

    def capture(run, device):
        outs = run()
        return Graph(run, outs), outs

    monkeypatch.setattr(executor, "_warm_up", lambda run, device: run())
    monkeypatch.setattr(executor, "_capture_graph", capture)
    monkeypatch.setattr(executor.StitchedExecutable, "replay_mode", property(lambda self: "graph"))


def _stitched_run(steps=20):
    """20 steps of the stitched step and of ``jax.jit(ref_step)`` (the
    reference's ``examples/train_stitched.py``) on the same batches: the
    port's metrics and final params, and the reference's."""
    rng = np.random.default_rng(0)
    oc = dict(lr=1e-3, warmup_steps=10, total_steps=100)
    rcfg = ropt.AdamWConfig(**oc)

    def ref_step(params, opt_state, batch):
        loss, grads = jax.value_and_grad(_ref_mlp_loss)(params, batch)
        params, opt_state, om = ropt.adamw_update(rcfg, params, grads, opt_state)
        return params, opt_state, {"loss": loss, **om}

    ref = jax.jit(ref_step)
    step = ttrain.make_stitched_train_step(_mlp_loss, topt.AdamWConfig(**oc),
                                           options=StitchOptions(max_blocks=32), device="cpu")
    params = _mlp_params(rng)
    rp, tp = jax.tree.map(jnp.asarray, params), _port(params)
    rs, ts = ropt.adamw_init(rp), topt.adamw_init(tp)
    rows = []
    for _ in range(steps):
        x = rng.normal(size=(BATCH, D_IN)).astype(np.float32)
        y = rng.normal(size=(BATCH, D_OUT)).astype(np.float32)
        rp, rs, rm = ref(rp, rs, (jnp.asarray(x), jnp.asarray(y)))
        tp, ts, tm = step(tp, ts, (torch.tensor(x), torch.tensor(y)))
        rows.append(({k: float(v) for k, v in rm.items()}, {k: v.clone() for k, v in tm.items()}))
    return step, rows, rp, tp, ts


def test_stitched_step_follows_the_jitted_reference():
    step, rows, rp, tp, ts = _stitched_run()
    for i, (rm, tm) in enumerate(rows):
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), rm[k], rtol=STITCH_TOL, atol=STITCH_TOL,
                                       err_msg=f"step {i} {k}")
    _close_trees(rp, tp, STITCH_TOL, STITCH_TOL)
    assert int(ts.step) == 20
    assert step.num_fallbacks == 0 and step.num_compiles == 1
    assert step.stats.stitched_kernels >= 1


def test_stitched_step_replayed_equals_eager(replay_stand_in):
    """Through the plan's CUDA-graph replay (a stand-in here), which reads
    its own copies of the feeds and writes no donated buffer: the caller
    rebinds to the outputs, and 20 steps equal the eager loop's bit for
    bit."""
    step, rows, _, tp, _ = _stitched_run()
    st = step.lower().compile().executable.execution_plan.stats
    assert st.traced_calls == 20 and st.graph_captures == 1 and st.eager_calls == 0
    eager = _stitched_eager()
    for (_, tm), (_, em) in zip(rows, eager[0], strict=True):
        for k in tm:
            assert torch.equal(tm[k], em[k])
    for k in tp:
        assert torch.equal(tp[k], eager[1][k])


def _stitched_eager():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(executor.StitchedExecutable, "replay_mode", property(lambda self: "eager"))
        step, rows, _, tp, _ = _stitched_run()
        st = step.lower().compile().executable.execution_plan.stats
        assert st.eager_calls == 20 and st.traced_calls == 0
    return rows, tp


# ---------------------------------------------------------- train, then serve
def test_train_then_serve_roundtrip():
    """The reference's ``tests/test_system.py`` lifecycle on the port: train a
    tiny LM until its loss drops, then serve greedy completions from the
    trained weights with the port's ``ServeEngine``."""
    from repro_torch.serve import Request, ServeEngine

    cfg = reduced_config(get_config("qwen1.5-0.5b"), num_layers=2, vocab_size=128)
    from repro_torch.models import init_params

    params = init_params(cfg, 0, device="cpu")
    opt = topt.adamw_init(params)
    step = ttrain.make_train_step(cfg, topt.AdamWConfig(lr=5e-3, warmup_steps=5, total_steps=60,
                                                        schedule="constant"))
    data = SyntheticLM(cfg, seq_len=24, global_batch=8, seed=3)
    losses = [float(step(params, opt, data.batch_at(i))[2]["loss"]) for i in range(50)]
    assert losses[-1] < losses[0] * 0.85
    engine = ServeEngine(cfg, params, pool_size=2, max_len=64, device="cpu")
    req = Request(rid=0, prompt=np.array([3, 14, 15]), max_new_tokens=8)
    assert engine.admit(req)
    engine.run_until_done()
    assert req.done and len(req.out_tokens) == 8
    assert all(0 <= t < cfg.vocab_size for t in req.out_tokens)


def test_opt_state_from_reference():
    rng = np.random.RandomState(0)
    tree = {"a": rng.randn(3, 2).astype(np.float32), "n": {"b": rng.randn(2).astype(np.float32)}}
    st = opt_state_from_reference(ropt.AdamWState(np.int32(7), tree, tree), device="cpu")
    assert int(st.step) == 7 and st.step.dtype == torch.int32
    assert tree_map(lambda t: t.dtype, st.m) == {"a": torch.float32, "n": {"b": torch.float32}}
    np.testing.assert_array_equal(st.v["n"]["b"].numpy(), tree["n"]["b"])
