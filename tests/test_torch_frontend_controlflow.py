"""Control-flow and gradient capture through ``repro_torch.stitch``, held
against ``jax.lax`` and ``jax.value_and_grad``: ``tests/test_frontend_
controlflow.py`` rewritten in PyTorch.

``torch._higher_order_ops.scan``, a counted ``while_loop`` and
``torch.cond`` compile with zero fallbacks and agree with ``jax.jit`` of
the ``jax.lax`` function at 2e-5; ``torch.func.grad_and_value`` of the MLP
loss agrees with ``jax.value_and_grad`` at 1e-5, and the port's eager and
replayed results are bit for bit equal (the replay driven on the CPU
through a stand-in for the CUDA graph, as ``tests/test_torch_replay.py``
drives it).  Plus the jit-parity surface: static arguments, donation.

What torch cannot express is left out or held: it has no n-way ``switch``
(the reference's ``test_nway_switch_raises`` has no counterpart) and no
bounded ``fori_loop`` (``test_fori_loop_static_bounds`` is a
``while_loop`` with a counter here); torch 2.13 cannot capture the
gradient of a ``scan``, which ``test_grad_of_scan_is_held`` holds.

A scan body that closes over a module-level tensor does not capture, so
the loops here take their weights as arguments (``additional_inputs``);
a scan "without xs" passes a (length, 0) dummy the lowering drops.
"""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._higher_order_ops.scan import scan
from torch._higher_order_ops.while_loop import while_loop

from repro_torch import StitchOptions, UnsupportedPrimitiveError, compile_module, stitch
from repro_torch.core import executor
from repro_torch.graphs import LOOP_GRAPHS

OPTS = StitchOptions(max_blocks=32)


def cpu_stitch(fn, **kw):
    return stitch(fn, options=kw.pop("options", OPTS), device="cpu", **kw)


def assert_tree_close(a, b, tol=2e-5):
    la, lb = jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb, strict=True):
        x = x.numpy() if isinstance(x, torch.Tensor) else x
        np.testing.assert_allclose(np.asarray(x, np.float64), np.asarray(y, np.float64),
                                   rtol=tol, atol=tol)


def assert_tree_bitwise(a, b):
    la, lb = jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb, strict=True):
        assert torch.equal(x, y)


class _StandIn:
    """A captured CUDA graph on the CPU: ``replay`` re-runs the captured
    steps into the same static outputs."""

    def __init__(self, run, outs):
        self.run, self.outs = run, outs

    def replay(self):
        for o, n in zip(self.outs, self.run(), strict=True):
            o.copy_(n)


@pytest.fixture
def stand_in(monkeypatch):
    monkeypatch.setattr(executor, "_warm_up", lambda run, device: run())

    def capture(run, device):
        outs = run()
        return _StandIn(run, outs), outs

    monkeypatch.setattr(executor, "_capture_graph", capture)


def decode_loop(h, w):
    def step(carry, _x):
        carry = torch.tanh(carry @ w)
        return carry.clone(), carry.sum(dim=-1)

    return scan(step, h, torch.zeros(6, 0, device=h.device))


def jnp_decode_loop(h, w):
    def step(carry, _):
        carry = jnp.tanh(carry @ w)
        return carry, carry.sum(axis=-1)

    return jax.lax.scan(step, h, None, length=6)


def _decode_data(seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(4, 16)).astype("f4"),
            rng.normal(size=(16, 16), scale=0.2).astype("f4"))


# --------------------------------------------------------------------------
# scan
# --------------------------------------------------------------------------


def test_scan_decode_loop_vs_jit():
    h, w = _decode_data(0)
    st = cpu_stitch(decode_loop)
    assert_tree_close(st(h, w), jax.jit(jnp_decode_loop)(h, w))
    assert st.num_fallbacks == 0
    s = st.stats
    assert s.loop_calls == 1 and s.sub_compiles == 1 and s.sub_kernels >= 1
    (call,) = [i for i in st.lower().instructions if i.opcode == "call"]
    assert len(call.operands) == 2          # w and h: the dummy xs are dropped
    hand = compile_module(LOOP_GRAPHS["DecodeLoop"](), OPTS, device="cpu").stats
    assert (s.loop_calls, s.sub_kernels) == (hand.loop_calls, hand.sub_kernels)


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reversed"])
def test_scan_with_xs(reverse):
    def fn(init, xs):
        def step(c, x):
            c = c * 0.9 + x
            return c.clone(), c - x

        return scan(step, init, xs, reverse=reverse)

    def jfn(init, xs):
        def step(c, x):
            c = c * 0.9 + x
            return c, c - x

        return jax.lax.scan(step, init, xs, reverse=reverse)

    xs = np.random.default_rng(1).normal(size=(5, 8)).astype("f4")
    init = np.ones(8, "f4")
    st = cpu_stitch(fn)
    assert_tree_close(st(init, xs), jax.jit(jfn)(init, xs))
    assert st.num_fallbacks == 0
    (call,) = [i for i in st.lower().instructions if i.opcode == "call"]
    assert call.attrs["reverse"] == reverse
    assert "gather" not in {i.opcode for i in st.lower().instructions}   # flips cancel


def test_two_identical_scans_share_one_compiled_body():
    def fn(a, w):
        c1, ys1 = decode_loop(a, w)
        c2, ys2 = decode_loop(a + 1.0, w)
        return c1 + c2, ys1 + ys2

    def jfn(a, w):
        c1, ys1 = jnp_decode_loop(a, w)
        c2, ys2 = jnp_decode_loop(a + 1.0, w)
        return c1 + c2, ys1 + ys2

    a, w = _decode_data(2)
    st = cpu_stitch(fn)
    assert_tree_close(st(a, w), jax.jit(jfn)(a, w))
    s = st.stats
    assert s.loop_calls == 2
    assert s.sub_compiles == 1              # module-signature dedup: one body, two sites
    assert s.sub_call_sites == 2


# --------------------------------------------------------------------------
# while_loop (and the fori_loop it stands for)
# --------------------------------------------------------------------------


def test_while_loop_counted():
    def fn(x):
        return while_loop(lambda i, v: i < 5, lambda i, v: (i + 1, v * 1.1 + 0.25),
                          (torch.tensor(0), x))[1]

    def jfn(x):
        return jax.lax.while_loop(lambda c: c[0] < 5,
                                  lambda c: (c[0] + 1, c[1] * 1.1 + 0.25), (0, x))[1]

    x = np.linspace(0.0, 1.0, 12, dtype="f4")
    st = cpu_stitch(fn)
    assert_tree_close(st(x), jax.jit(jfn)(x))
    assert st.num_fallbacks == 0
    (call,) = [i for i in st.lower().instructions if i.opcode == "call"]
    assert call.attrs["trip_count"] == 5 and call.attrs["kind"] == "while"


def test_fori_loop_static_bounds():
    """``lax.fori_loop(0, 4, ...)``: torch has no bounded fori_loop, so the
    counter is a ``while_loop`` carry; the body's closure over an argument
    becomes an additional input, the loop's constant."""
    def fn(x, half):
        return while_loop(lambda i, c: i < 4, lambda i, c: (i + 1, c @ c * half),
                          (torch.tensor(0), x))[1]

    def jfn(x):
        return jax.lax.fori_loop(0, 4, lambda i, c: c @ c * 0.5, x)

    x = np.eye(8, dtype="f4") * 1.5
    st = cpu_stitch(fn)
    assert_tree_close(st(x, np.float32(0.5)), jax.jit(jfn)(x))
    assert st.num_fallbacks == 0


def test_data_dependent_while_raises():
    def fn(x):
        return while_loop(lambda v: v.sum() < 100.0, lambda v: (v * 2.0,), (x,))[0]

    with pytest.raises(UnsupportedPrimitiveError) as err:
        cpu_stitch(fn)(torch.ones(4))
    assert err.value.primitive == "while_loop"


# --------------------------------------------------------------------------
# cond
# --------------------------------------------------------------------------


@pytest.mark.parametrize("flag", [False, True])
def test_cond_inlines_via_select(flag):
    def fn(pred, x):
        return torch.cond(pred, lambda v: v * 2.0, lambda v: v - 1.0, (x,))

    def jfn(pred, x):
        return jax.lax.cond(pred, lambda v: v * 2.0, lambda v: v - 1.0, x)

    x = np.arange(8, dtype="f4")
    st = cpu_stitch(fn)
    assert_tree_close(st(np.asarray(flag), x), jax.jit(jfn)(np.asarray(flag), x))
    assert st.num_fallbacks == 0
    assert "select" in {i.opcode for i in st.lower().instructions}


# --------------------------------------------------------------------------
# gradients
# --------------------------------------------------------------------------


def mlp_loss(params, x, y):
    h = torch.tanh(x @ params["w1"] + params["b1"])
    pred = h @ params["w2"] + params["b2"]
    return torch.mean((pred - y) ** 2)


def jnp_mlp_loss(params, x, y):
    h = jnp.tanh(x @ params["w1"] + params["b1"])
    pred = h @ params["w2"] + params["b2"]
    return jnp.mean((pred - y) ** 2)


def _mlp_data(seed=0):
    rng = np.random.default_rng(seed)
    params = {
        "w1": rng.normal(size=(8, 16), scale=0.3).astype("f4"),
        "b1": np.zeros(16, "f4"),
        "w2": rng.normal(size=(16, 4), scale=0.3).astype("f4"),
        "b2": np.zeros(4, "f4"),
    }
    return params, rng.normal(size=(32, 8)).astype("f4"), rng.normal(size=(32, 4)).astype("f4")


def test_grad_mlp_vs_value_and_grad(stand_in):
    """Forward and backward lower as one plan; (grads, loss) agree with
    ``jax.value_and_grad`` at 1e-5, and the replayed call is bit for bit
    the eager one."""
    params, x, y = _mlp_data()
    st = cpu_stitch(torch.func.grad_and_value(mlp_loss))
    grads, loss = st(params, x, y)
    jloss, jgrads = jax.jit(jax.value_and_grad(jnp_mlp_loss))(params, x, y)
    assert_tree_close((grads, loss), (jgrads, jloss), tol=1e-5)
    assert st.num_fallbacks == 0 and st.num_compiles == 1
    assert st.stats.stitched_kernels >= 1
    lowered = st.lower()
    leaves = torch.utils._pytree.tree_leaves((params, x, y))
    feeds = dict(zip(lowered.param_names, leaves, strict=True))
    exe = lowered.compile().executable
    eager, replayed = exe.execute_eager(feeds), exe.jit_execute(feeds)
    assert exe.execution_plan.stats.traced_calls == 1
    for name in eager:
        assert torch.equal(eager[name], replayed[name]), name


def test_grad_of_scan_is_held():
    """torch 2.13 cannot capture ``grad`` of a ``scan``: the capture raises
    ``UnsupportedPrimitiveError`` naming the op (ROADMAP queue 3, Held).
    Its eager run fails the same way, so "fallback" cannot serve it."""
    def loss(w, h):
        c, ys = decode_loop(h, w)
        return torch.sum(c ** 2) + torch.sum(ys)

    h, w = _decode_data(4)
    with pytest.raises(UnsupportedPrimitiveError) as err:
        cpu_stitch(torch.func.grad(loss))(w, h)
    assert err.value.primitive == "higher_order.scan"


# --------------------------------------------------------------------------
# jit-parity API: statics, donation
# --------------------------------------------------------------------------


def test_static_argnums_key_the_plan_cache():
    st = cpu_stitch(lambda x, n: x * float(n), static_argnums=(1,))
    x = torch.ones(4)
    np.testing.assert_array_equal(st(x, 2).numpy(), 2 * np.ones(4))
    np.testing.assert_array_equal(st(x, 3).numpy(), 3 * np.ones(4))
    assert st.num_compiles == 2             # distinct static values -> distinct plans
    st(x, 2)
    assert st.num_compiles == 2             # a cache hit on a seen static


def test_static_argnames_and_nonhashable_rejection():
    def fn(x, *, mode="a"):
        return x + (1.0 if mode == "a" else 2.0)

    st = cpu_stitch(fn, static_argnames="mode")
    x = torch.zeros(4)
    np.testing.assert_array_equal(st(x, mode="a").numpy(), np.ones(4))
    np.testing.assert_array_equal(st(x, mode="b").numpy(), 2 * np.ones(4))
    with pytest.raises(TypeError, match="hashable"):
        cpu_stitch(lambda x, c: x, static_argnums=(1,))(x, [1, 2])


def _donating_fn(x, w, y):
    """exp, a library dot (``fuse_dot=False``), then tanh: two kernels, the
    second writing an output of the first's input's shape and dtype."""
    return torch.tanh(torch.exp(x) @ w) + y


def _donating_args():
    rng = np.random.RandomState(0)
    return tuple(torch.from_numpy(rng.randn(8, 8).astype(np.float32)) for _ in range(3))


NO_FUSED_DOT = replace(OPTS, fuse_dot=False)


def test_donation_threads_to_the_plan_and_spares_other_buffers():
    """``donate_argnums`` reaches the plan (``donate_params``): the second
    kernel writes its output into the donated input's buffer, once the
    first kernel, its last reader, has run.  An input that was not donated
    is never written, and the result is the undonated plan's, bit for
    bit."""
    x, w, y = _donating_args()
    want = cpu_stitch(_donating_fn, options=NO_FUSED_DOT)(x, w, y)
    w_before, y_before = w.clone(), y.clone()
    st = cpu_stitch(_donating_fn, options=NO_FUSED_DOT, donate_argnums=(0,))
    out = st(x, w, y)
    assert torch.equal(out, want)
    assert out.data_ptr() == x.data_ptr()
    assert torch.equal(w, w_before) and torch.equal(y, y_before)
    assert st.num_fallbacks == 0
    assert st.stats.donated_buffers == 1
    plan = st.lower().compile().executable.execution_plan
    names = {slot: name for name, slot, _, _ in plan._param_binds}
    assert {names[p] for p in plan.donations} == {"arg0"}
    # the donated slot is released where its buffer is taken, not before
    assert all(p in plan.steps[si].release for p, si in plan.donations.items())


@pytest.mark.parametrize("case", ["one_tensor_twice", "not_contiguous", "read_by_a_torch_op",
                                  "no_later_kernel", "replayed"])
def test_donation_writes_only_a_buffer_it_may(case, stand_in):
    """Where a donated buffer may not be written, the call leaves it as it
    is and gives the undonated plan's result, bit for bit: one tensor
    passed as a donated and an undonated argument, a non-contiguous donated
    view, a donated input a torch op reads (its output may be a view), a
    plan with no kernel after the input's last read, and the replay (it
    reads its own copies of the feeds)."""
    x, w, y = _donating_args()
    fn, opts, args = _donating_fn, NO_FUSED_DOT, (x, w, y)
    if case == "one_tensor_twice":
        args = (x, w, x)
    elif case == "not_contiguous":
        args = (x.t(), w, y)
    elif case == "read_by_a_torch_op":
        fn, args = (lambda a, b: torch.tanh(a @ b) + 1.0), (x, w)
    elif case == "no_later_kernel":
        fn, opts, args = (lambda a, b: torch.exp(a) + b), OPTS, (x, y)
    want = cpu_stitch(fn, options=opts)(*[a.clone() for a in args])
    before = [a.clone() for a in args]
    st = cpu_stitch(fn, options=opts, donate_argnums=(0,))
    out = st(*args)
    if case == "replayed":
        lowered = st.lower()
        ex = lowered.compile().executable
        x, w, y = before
        args = (x, w, y)
        out = ex.jit_execute(dict(zip(lowered.param_names, args, strict=True)))
        out = out[lowered._lowered.output_names[0]]
    assert torch.equal(out, want)
    for a, b in zip(args, before, strict=True):
        assert torch.equal(a, b)
    planned = case in ("one_tensor_twice", "not_contiguous", "replayed")
    assert st.stats.donated_buffers == planned
@pytest.mark.parametrize("case", ["overlap", "out_of_range", "unknown_param"])
def test_donation_rejections(case):
    if case == "overlap":
        with pytest.raises(ValueError, match="intersect"):
            stitch(lambda x: x, static_argnums=(0,), donate_argnums=(0,))
    elif case == "out_of_range":
        with pytest.raises(ValueError, match="out of range"):
            cpu_stitch(lambda x: x * 2.0, donate_argnums=(3,))(torch.ones(4))
    else:
        st = cpu_stitch(lambda x: x * 2.0)
        st(torch.ones(4))
        with pytest.raises(ValueError, match="donate_params"):
            compile_module(st.lower().module, OPTS, device="cpu", donate_params={"nope"})


def test_replay_options_do_not_change_results(stand_in):
    """``jit_replay`` off and on give the same plan results (the eager loop
    is the CPU's path either way; the replay is driven explicitly)."""
    h, w = _decode_data(5)
    eager = cpu_stitch(decode_loop, options=replace(OPTS, jit_replay=False))
    assert_tree_bitwise(eager(h, w), cpu_stitch(decode_loop)(h, w))
