"""The port's frontend, ``repro_torch.stitch``, held against the reference's:
``tests/test_frontend.py`` rewritten in PyTorch.

Every function here is the reference test's jnp function rewritten in
torch; both run on the same numpy inputs, the port on ``device="cpu"``
(every kernel its plain version) and the JAX function under ``jax.jit``.
The reference's own frontend fails on some of them (its ``CALL_PRIMS``
lack ``jit`` under jax 0.9), so numbers are held against ``jax.jit`` of
the JAX function, kernel counts against the hand-built graphs compiled by
both packages, and plans against ``repro.stitch`` only where the
reference's frontend works (NMT, ReduceTowers).
"""
import os
import sys
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
import torch.utils.checkpoint

import repro
from repro_torch import (
    SUPPORTED_OPS,
    Lowered,
    StitchedFunction,
    StitchOptions,
    UnsupportedPrimitiveError,
    compile_module,
    lower_graph,
    reference_execute,
    stitch,
)
from repro_torch.core.ir import BFLOAT16, Module
from repro_torch.frontend import capture
from repro_torch.graphs import TORCH_FAMILIES

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "benchmarks"))
from graphs import JNP_FAMILIES  # noqa: E402

OPTS = StitchOptions(max_blocks=32)
REF_OPTS = repro.StitchOptions(max_blocks=32)


def cpu_stitch(fn, **kw):
    return stitch(fn, options=kw.pop("options", OPTS), device="cpu", **kw)


def leaves(tree):
    return [np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor) else x, np.float64)
            for x in jax.tree_util.tree_leaves(tree)]


def assert_tree_close(a, b, rtol=2e-5, atol=2e-5):
    la, lb = leaves(a), leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb, strict=True):
        np.testing.assert_allclose(x, y, rtol=rtol, atol=atol)


def counts(stats):
    return (stats.stitched_kernels, stats.standalone_kernels, stats.library_calls)


# --------------------------------------------------------------------------
# end-to-end: plain torch functions, zero GraphBuilder calls, beside the
# reference test's jnp functions
# --------------------------------------------------------------------------


def fig3_attention(q, k, v):
    d = q.shape[-1]
    s = torch.matmul(q, k.transpose(-1, -2)) * (1.0 / d ** 0.5)
    s = s - torch.amax(s, dim=-1, keepdim=True)
    e = torch.exp(s)
    return torch.matmul(e / torch.sum(e, dim=-1, keepdim=True), v)


def rmsnorm(x, g):
    ms = torch.mean(torch.square(x), dim=-1, keepdim=True)
    return x * torch.rsqrt(ms + 1e-6) * g


def gated_mlp(x, w_gate, w_up):
    return F.silu(torch.matmul(x, w_gate)) * torch.matmul(x, w_up)


def layer_stats(x):
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + 1e-5)


def speech_head(x):
    lg = torch.log(torch.clamp(torch.square(x), min=1e-6))
    tr = lg.permute(0, 2, 1)
    feats = torch.cat([tr, tr * 0.5 + 0.1], dim=1)
    return torch.mean(torch.sigmoid(feats) * feats, dim=2)


def jnp_fig3_attention(q, k, v):
    d = q.shape[-1]
    s = jnp.matmul(q, jnp.swapaxes(k, -1, -2)) * (1.0 / d ** 0.5)
    s = s - jnp.max(s, axis=-1, keepdims=True)
    e = jnp.exp(s)
    return jnp.matmul(e / jnp.sum(e, axis=-1, keepdims=True), v)


def jnp_rmsnorm(x, g):
    ms = jnp.mean(jnp.square(x), axis=-1, keepdims=True)
    return x * jax.lax.rsqrt(ms + 1e-6) * g


def jnp_gated_mlp(x, w_gate, w_up):
    return jax.nn.silu(jnp.matmul(x, w_gate)) * jnp.matmul(x, w_up)


def jnp_layer_stats(x):
    mu = jnp.mean(x, axis=-1, keepdims=True)
    var = jnp.mean(jnp.square(x - mu), axis=-1, keepdims=True)
    return (x - mu) * jax.lax.rsqrt(var + 1e-5)


def jnp_speech_head(x):
    lg = jnp.log(jnp.maximum(jnp.square(x), 1e-6))
    tr = jnp.transpose(lg, (0, 2, 1))
    feats = jnp.concatenate([tr, tr * 0.5 + 0.1], axis=1)
    return jnp.mean(jax.nn.sigmoid(feats) * feats, axis=2)


END_TO_END = {
    "fig3_attention": (fig3_attention, jnp_fig3_attention, [(2, 4, 16, 32)] * 3),
    "rmsnorm": (rmsnorm, jnp_rmsnorm, [(16, 64), (64,)]),
    "gated_mlp": (gated_mlp, jnp_gated_mlp, [(16, 64), (64, 128), (64, 128)]),
    "layer_stats": (layer_stats, jnp_layer_stats, [(8, 96)]),
    "speech_head": (speech_head, jnp_speech_head, [(4, 20, 16)]),
}


@pytest.mark.parametrize("name", list(END_TO_END))
def test_stitch_end_to_end(name):
    """The five end-to-end functions agree with ``jax.jit`` at 2e-5, and
    the compiled plan agrees with ``reference_execute`` of its module."""
    fn, jfn, shapes = END_TO_END[name]
    rng = np.random.RandomState(0)
    args = [rng.randn(*s).astype("f4") for s in shapes]
    st = cpu_stitch(fn)
    out = st(*args)
    assert isinstance(out, torch.Tensor) and out.device.type == "cpu"
    assert_tree_close(out, jax.jit(jfn)(*args))
    assert st.num_compiles == 1 and st.num_fallbacks == 0
    assert st.stats.stitched_kernels + st.stats.standalone_kernels >= 1
    lowered = st.lower()
    ref = reference_execute(lowered.module, dict(zip(lowered.param_names, args, strict=True)),
                            device="cpu")
    assert_tree_close(out, ref[lowered._lowered.output_names[0]])


@pytest.mark.parametrize("family", sorted(TORCH_FAMILIES))
def test_parity_with_hand_built_modules(family):
    """The frontend reproduces the hand-built plans: the same stitched,
    standalone and library counts as the hand-built module under both
    packages' ``compile_module`` (and as ``repro.stitch`` of the jnp
    function where the reference's frontend works), outputs at 2e-4 of
    ``jax.jit`` of the jnp function."""
    fam, jfam = TORCH_FAMILIES[family], JNP_FAMILIES[family]
    args = fam["args"](np.random.RandomState(0))
    st = cpu_stitch(fam["fn"], options=replace(OPTS, **fam["options"]))
    assert_tree_close(st(*args), jax.jit(jfam["fn"])(*args), rtol=2e-4, atol=2e-4)
    assert st.num_fallbacks == 0
    port_hand = compile_module(fam["module"](), OPTS, device="cpu").stats
    ref_hand = repro.compile_module(jfam["module"](), REF_OPTS).stats
    assert counts(st.stats) == counts(port_hand) == counts(ref_hand), family
    if family in ("NMT", "ReduceTowers"):
        ref_st = repro.stitch(jfam["fn"], options=replace(REF_OPTS, **jfam["options"]))
        ref_st(*args)
        assert counts(st.stats) == counts(ref_st.stats)


def stitch_pipe(x, g):
    scaled = x * g
    e = torch.exp(scaled - torch.amax(scaled, dim=1, keepdim=True))
    p = e / torch.sum(e, dim=1, keepdim=True)
    return torch.tanh(p.transpose(0, 1)) * 0.5


def jnp_stitch_pipe(x, g):
    scaled = x * g
    e = jnp.exp(scaled - jnp.max(scaled, axis=1, keepdims=True))
    p = e / jnp.sum(e, axis=1, keepdims=True)
    return jnp.tanh(p.T) * 0.5


def test_stitch_pipe_takes_the_stitched_emitter():
    """StitchPipe's computation as a plain function: one multi-phase
    kernel through ``emit_stitched_fusion``, as the hand-built graph
    compiles under both packages."""
    from graphs import stitch_pipeline_graph as ref_stitch_pipeline_graph

    from repro_torch.graphs import stitch_pipeline_graph

    rng = np.random.RandomState(22)
    x, g = rng.randn(512, 320).astype("f4"), rng.randn(320).astype("f4")
    st = cpu_stitch(stitch_pipe)
    assert_tree_close(st(x, g), jax.jit(jnp_stitch_pipe)(x, g))
    s = st.stats
    assert s.stitch_lowered_kernels == 1 and s.stitch_phases_total >= 2
    port_hand = compile_module(stitch_pipeline_graph(), OPTS, device="cpu").stats
    ref_hand = repro.compile_module(ref_stitch_pipeline_graph(), REF_OPTS).stats
    assert counts(s) == counts(port_hand) == counts(ref_hand) == (1, 0, 0)
    assert s.stitch_phases_total == port_hand.stitch_phases_total == ref_hand.stitch_phases_total


def test_fig3_attention_single_stitched_kernel():
    """The paper's headline: attention lowers to ONE stitched kernel, and
    ``q @ k.transpose(-1, -2)`` to a transpose and a dot, nothing more."""
    rng = np.random.RandomState(1)
    st = cpu_stitch(fig3_attention)
    st(*[rng.randn(2, 4, 16, 32).astype("f4") for _ in range(3)])
    assert st.stats.stitched_kernels == 1
    assert st.stats.standalone_kernels == 0
    ops = [i.opcode for i in st.lower().instructions]
    assert ops.count("dot") == 2 and ops.count("transpose") == 1
    assert "reshape" not in ops


# --------------------------------------------------------------------------
# the per-signature plan cache
# --------------------------------------------------------------------------


def test_plan_cache_no_recompile_at_same_shape():
    rng = np.random.RandomState(2)
    st = cpu_stitch(rmsnorm)
    x, g = rng.randn(16, 64).astype("f4"), rng.randn(64).astype("f4")
    st(x, g)
    assert st.num_compiles == 1
    st(x + 1, g)                            # same signature, new values
    assert st.num_compiles == 1
    st(x[:8], g)                            # new shape: recompile once
    assert st.num_compiles == 2
    out = st(x[:8] * 2, g)
    assert st.num_compiles == 2
    assert_tree_close(out, jax.jit(jnp_rmsnorm)(x[:8] * 2, g))


def test_plan_cache_distinguishes_dtypes():
    st = cpu_stitch(lambda x: x * 2 + 1)
    x = np.random.RandomState(3).randn(8, 8)
    st(x.astype("f4"))
    st(x.astype("f4") * 3)
    assert st.num_compiles == 1
    out = st(np.abs(x).astype("i4"))
    assert st.num_compiles == 2
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), np.abs(x).astype("i4") * 2 + 1)


def test_one_tensor_passed_twice_then_distinct_tensors():
    """The capture runs on fresh tensors, never the caller's: a first call
    with one tensor as all three arguments must not give a plan that reads
    one argument for all three."""
    rng = np.random.RandomState(4)
    st = cpu_stitch(fig3_attention)
    q = torch.as_tensor(rng.randn(2, 4, 16, 32).astype("f4"))
    assert_tree_close(st(q, q, q), fig3_attention(q, q, q))
    k, v = (torch.as_tensor(rng.randn(2, 4, 16, 32).astype("f4")) for _ in range(2))
    assert_tree_close(st(q, k, v), fig3_attention(q, k, v))
    assert st.num_compiles == 1
    assert len(st.lower().parameters) == 3


def test_python_scalar_keys_the_plan_cache():
    """A Python number is baked into the capture, so it keys the cache by
    its value: never another value's plan."""
    st = cpu_stitch(lambda x, s: x * s)
    x = torch.ones(4)
    np.testing.assert_array_equal(st(x, 2.0).numpy(), 2 * np.ones(4))
    np.testing.assert_array_equal(st(x, 3.0).numpy(), 3 * np.ones(4))
    assert st.num_compiles == 2
    st(x, 2.0)
    assert st.num_compiles == 2


def test_bf16_inputs_map_to_the_ir_bfloat16():
    st = cpu_stitch(lambda x: x * 2 + 1)
    x = torch.randn(8, 8).to(torch.bfloat16)
    out = st(x)
    assert out.dtype == torch.bfloat16
    assert np.dtype(st.lower().parameters[0].dtype) == BFLOAT16
    torch.testing.assert_close(out, x * 2 + 1, rtol=0, atol=0)


def test_integer_sums_take_torchs_dtype():
    """torch promotes an int32 sum to int64 where jnp keeps int32: the
    lowering takes each node's dtype from the capture."""
    st = cpu_stitch(lambda n: n.sum(0))
    n = np.random.RandomState(5).randint(0, 9, size=(4, 6)).astype("i4")
    out = st(n)
    assert out.dtype == torch.int64
    np.testing.assert_array_equal(out.numpy(), n.sum(0))


# --------------------------------------------------------------------------
# pytrees, kwargs, aliased outputs, closures
# --------------------------------------------------------------------------


def test_pytree_inputs_and_outputs():
    def fn(params, x):
        h = torch.tanh(torch.matmul(x, params["w"]) + params["b"])
        return {"h": h, "norms": (torch.sum(h * h), torch.amax(h))}

    def jfn(params, x):
        h = jnp.tanh(jnp.matmul(x, params["w"]) + params["b"])
        return {"h": h, "norms": (jnp.sum(h * h), jnp.max(h))}

    rng = np.random.RandomState(6)
    params = {"w": rng.randn(8, 4).astype("f4"), "b": rng.randn(4).astype("f4")}
    x = rng.randn(3, 8).astype("f4")
    out = cpu_stitch(fn)(params, x)
    assert set(out) == {"h", "norms"} and isinstance(out["norms"], tuple)
    assert_tree_close(out, jax.jit(jfn)(params, x))


def test_kwargs_supported():
    x = np.random.RandomState(7).randn(4, 4).astype("f4")
    out = cpu_stitch(lambda x, scale: x * scale)(x, scale=torch.tensor(2.5))
    assert_tree_close(out, x * 2.5)


def test_aliased_and_duplicate_outputs():
    """Outputs that alias a parameter, an interior value, or repeat must
    still materialize (reshape sinks keep them as module roots)."""
    def fn(x):
        y = torch.exp(x)
        return x, y, y * 2.0, y

    x = np.random.RandomState(8).randn(4, 4).astype("f4")
    out = cpu_stitch(fn)(x)
    assert_tree_close(out, jax.jit(lambda x: (x, jnp.exp(x), jnp.exp(x) * 2.0, jnp.exp(x)))(x))


def test_closure_constants_fold():
    rng = np.random.RandomState(9)
    table = torch.as_tensor(rng.randn(8, 8).astype("f4"))
    st = cpu_stitch(lambda x: torch.matmul(x, table * 2.0))
    x = rng.randn(4, 8).astype("f4")
    assert_tree_close(st(x), jax.jit(lambda x: jnp.matmul(x, table.numpy() * 2.0))(x))
    module = st.lower()
    assert any(i.opcode == "constant" for i in module.instructions)
    assert len(module.parameters) == 1      # the closure tensor is NOT a feed


def test_dead_code_is_eliminated():
    """The capture does not dead-code-eliminate; the lowering must, or dead
    subgraphs become module roots computed on every call."""
    def fn(x):
        dead = torch.exp(x) / torch.sum(torch.tanh(x))     # unused chain
        _also_dead = torch.where(x > 0, dead, x)           # unused select
        return x + 1.0

    x = np.random.RandomState(10).randn(4, 4).astype("f4")
    st = cpu_stitch(fn)
    assert_tree_close(st(x), x + 1.0)
    m = st.lower()
    opcodes = {i.opcode for i in m.instructions}
    fns = {i.attrs.get("fn") for i in m.instructions if i.opcode == "elementwise"}
    assert "reduce" not in opcodes and "select" not in opcodes
    assert "exp" not in fns and "tanh" not in fns
    assert len(m.roots) == 1


def test_dead_closure_constant_not_materialized():
    big = torch.ones(64, 64)

    def fn(x):
        _dead = torch.matmul(x, big)
        return x * 2.0

    x = np.random.RandomState(11).randn(4, 64).astype("f4")
    st = cpu_stitch(fn)
    assert_tree_close(st(x), x * 2.0)
    m = st.lower()
    assert not any(i.opcode == "constant" and i.num_elements > 1 for i in m.instructions)
    assert "dot" not in {i.opcode for i in m.instructions}


def test_unused_argument_stays_a_parameter():
    st = cpu_stitch(lambda x, unused: x * 3.0)
    rng = np.random.RandomState(12)
    x, u = rng.randn(4, 4).astype("f4"), rng.randn(8).astype("f4")
    assert_tree_close(st(x, u), x * 3.0)
    assert [p.name for p in st.lower().parameters] == ["arg0", "arg1"]


# --------------------------------------------------------------------------
# effects, errors and the fallback
# --------------------------------------------------------------------------


def _print_then_add(x):
    torch.ops.aten._print("x seen")
    return x + 1.0


EFFECTS = {
    "rand_like": (lambda x: x + torch.rand_like(x), "aten.rand_like.default"),
    "dropout": (lambda x: F.dropout(x, 0.5, training=True), "aten.bernoulli.p"),
    "_print": (_print_then_add, "aten._print.default"),
}


@pytest.mark.parametrize("name", list(EFFECTS))
def test_effects_raise_and_run_under_fallback(name):
    """A nondeterministic or side-effecting op raises rather than being
    dropped into silent divergence, and runs eagerly under "fallback"."""
    fn, op = EFFECTS[name]
    x = torch.ones(4, 4)
    with pytest.raises(UnsupportedPrimitiveError) as err:
        cpu_stitch(fn)(x)
    assert err.value.primitive == op
    fb = cpu_stitch(fn, on_unsupported="fallback")
    out = fb(x)
    assert out.shape == (4, 4) and fb.num_fallbacks == 1 and fb.num_compiles == 0
    if name == "_print":
        assert_tree_close(out, x + 1.0)


def test_checkpoint_inlines():
    def fn(x):
        inner = torch.utils.checkpoint.checkpoint(lambda y: torch.tanh(y) * 2.0, x,
                                                  use_reentrant=False)
        return inner + x

    x = np.random.RandomState(13).randn(4, 4).astype("f4")
    st = cpu_stitch(fn)
    assert_tree_close(st(x), jax.jit(lambda x: jax.checkpoint(lambda y: jnp.tanh(y) * 2.0)(x) + x)(x))
    assert st.num_compiles == 1


def test_stats_error_names_fallback_cause():
    fb = cpu_stitch(lambda x: torch.cumprod(x, 0), on_unsupported="fallback")
    fb(torch.ones(4, 4))
    with pytest.raises(ValueError, match="fell back to plain"):
        fb.stats


def test_unsupported_op_error_names_the_op_and_node():
    def fn(x):
        return torch.cumprod(x, 0) * 2.0

    with pytest.raises(UnsupportedPrimitiveError) as err:
        cpu_stitch(fn)(torch.ones(4, 4))
    e = err.value
    assert e.primitive == "aten.cumprod.default"
    assert e.node is not None and "cumprod" in e.node.format_node()
    assert "fallback" in str(e)                         # points at the escape hatch
    assert "%cumprod" in str(e)                         # the node, by name
    assert "aten.cumprod.default" not in SUPPORTED_OPS


def test_fallback_mode_runs_eagerly():
    fn = lambda x: torch.cumprod(x, 0) + 1.0  # noqa: E731
    st = cpu_stitch(fn, on_unsupported="fallback")
    x = np.random.RandomState(14).randn(4, 4).astype("f4")
    assert_tree_close(st(x), jax.jit(lambda x: jnp.cumprod(x, axis=0) + 1.0)(x))
    assert st.num_fallbacks == 1 and st.num_compiles == 0
    st(x)                                   # the fallback entry is cached too
    assert st.num_fallbacks == 1


def test_fallback_mode_still_stitches_supported_fns():
    st = cpu_stitch(rmsnorm, on_unsupported="fallback")
    rng = np.random.RandomState(15)
    x, g = rng.randn(16, 64).astype("f4"), rng.randn(64).astype("f4")
    assert_tree_close(st(x, g), jax.jit(jnp_rmsnorm)(x, g))
    assert st.num_compiles == 1 and st.num_fallbacks == 0


# --------------------------------------------------------------------------
# lowering coverage details
# --------------------------------------------------------------------------


def test_noncanonical_matmul_layouts():
    def fn(a, b, c):
        y = torch.einsum("bij,bkj->bik", a, b)   # contract rhs last dim
        z = torch.matmul(y, c)                   # matvec: (B,I,K) @ (K,)
        return torch.sum(z, dim=-1)

    def jfn(a, b, c):
        return jnp.sum(jnp.matmul(jnp.einsum("bij,bkj->bik", a, b), c), axis=-1)

    rng = np.random.RandomState(16)
    a, b, c = (rng.randn(2, 3, 5).astype("f4"), rng.randn(2, 4, 5).astype("f4"),
               rng.randn(4).astype("f4"))
    assert_tree_close(cpu_stitch(fn)(a, b, c), jax.jit(jfn)(a, b, c))


def test_integer_pow_and_reciprocal():
    x = np.abs(np.random.RandomState(17).randn(4, 4)).astype("f4") + 0.5
    st = cpu_stitch(lambda x: x ** 3 + (x + 2.0) ** -2)
    assert_tree_close(st(x), jax.jit(lambda x: x ** 3 + (x + 2.0) ** -2)(x))
    fns = [i.attrs.get("fn") for i in st.lower().instructions]
    assert "pow" not in fns and "reciprocal" in fns


def test_select_convert_and_compare():
    def fn(x):
        mask = x > 0
        return torch.where(mask, x, -x) + mask.to(torch.float32)

    x = np.random.RandomState(18).randn(8, 8).astype("f4")
    jfn = lambda x: jnp.where(x > 0, x, -x) + (x > 0).astype(jnp.float32)  # noqa: E731
    assert_tree_close(cpu_stitch(fn)(x), jax.jit(jfn)(x))


def test_detach_and_int_inputs():
    def fn(x, n):
        return x.detach() * n.to(torch.float32)

    rng = np.random.RandomState(19)
    x = rng.randn(4, 4).astype("f4")
    n = rng.randint(0, 5, size=(4, 4)).astype("i4")
    jfn = lambda x, n: jax.lax.stop_gradient(x) * n.astype(jnp.float32)  # noqa: E731
    assert_tree_close(cpu_stitch(fn)(x, n), jax.jit(jfn)(x, n))


# --------------------------------------------------------------------------
# lower(), decorators, options
# --------------------------------------------------------------------------


def test_lower_returns_lowered_handle():
    st = cpu_stitch(rmsnorm)
    m = st.lower(torch.empty(16, 64, device="meta"), torch.empty(64, device="meta"))
    assert isinstance(m, Lowered)
    assert isinstance(m.module, Module)
    assert [p.shape for p in m.parameters] == [(16, 64), (64,)]
    assert st.num_compiles == 0             # lowering never compiles
    with pytest.raises(ValueError, match="has not been compiled"):
        st.stats
    assert m.num_kernels >= 1 and m.cost_estimate().analytic_s > 0
    assert "parameter" in m.as_text()
    st(np.ones((16, 64), "f4"), np.ones(64, "f4"))
    assert isinstance(st.lower(), Lowered)
    assert "rmsnorm" in st.report()


def test_decorator_forms():
    @stitch
    def f1(x):
        return x * 2.0

    @stitch(options=StitchOptions(planner="greedy", max_blocks=32), device="cpu")
    def f2(x):
        return x + 1.0

    x = np.random.RandomState(20).randn(4, 4).astype("f4")
    assert isinstance(f1, StitchedFunction) and isinstance(f2, StitchedFunction)
    assert f1.device is None and f2.options.planner == "greedy"
    assert_tree_close(f2(x), x + 1.0)


def test_the_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        stitch(lambda x: x * 2.0)(torch.ones(4))


@pytest.mark.parametrize("bad", ["mode", "callable", "mesh"])
def test_option_validation(bad):
    if bad == "mode":
        with pytest.raises(ValueError, match="on_unsupported"):
            stitch(lambda x: x, on_unsupported="ignore")
    elif bad == "callable":
        with pytest.raises(TypeError, match="callable"):
            stitch(42)
    else:
        # the reference's refusal: a mesh needs the placement of every
        # argument and output
        with pytest.raises(ValueError, match="in_specs"):
            stitch(lambda x: x, mesh=object())


def test_lower_graph_standalone():
    gm, _ = capture(rmsnorm, [torch.empty(8, 32), torch.empty(32)],
                    torch.utils._pytree.tree_flatten(((1, 2), {}))[1])
    lowered = lower_graph(gm, name="rms", param_names=["x", "g"])
    assert [p.name for p in lowered.module.parameters] == ["x", "g"]
    rng = np.random.RandomState(21)
    x, g = rng.randn(8, 32).astype("f4"), rng.randn(32).astype("f4")
    out = reference_execute(lowered.module, {"x": x, "g": g}, device="cpu")
    assert_tree_close([out[n] for n in lowered.output_names], [jnp_rmsnorm(x, g)])
