"""The port's ``apply_op`` against the reference's, opcode by opcode.

Each case builds one instruction with the reference ``GraphBuilder``,
carries it across with ``module_from_reference``, and evaluates both
interpreters on the same seeded numpy inputs (JAX on the CPU, torch on the
CPU).  Float results agree to rtol/atol 1e-6, except where a looser bound
is stated beside the case.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from repro.core import ir as rir
from repro_torch.core import ir as tir
from repro_torch.core.interop import module_from_reference

TOL = 1e-6
# XLA's CPU backend and torch evaluate transcendental functions with their
# own polynomial/rational approximations; they sit a few ulp apart (f32 ulp
# is 1.2e-7 relative), so these get 4e-6 relative and absolute.
TRANSCENDENTAL_TOL = 4e-6
TRANSCENDENTAL = {"exp", "log", "tanh", "sigmoid", "softplus", "silu", "gelu",
                  "pow", "cos", "sin", "sqrt", "rsqrt"}


def _pair(build):
    """Build one instruction in the reference IR; return it and its copy."""
    b = rir.GraphBuilder("op")
    out = build(b)
    ported = module_from_reference(b.module)
    twin = next(i for i in ported.instructions if i.id == out.instr.id)
    return out.instr, twin


def _run(ref_instr, port_instr, *arrays):
    want = np.asarray(rir.apply_op(ref_instr, *[jnp.asarray(a) for a in arrays]))
    got = tir.apply_op(port_instr, *[torch.as_tensor(a) for a in arrays]).numpy()
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    assert got.shape == want.shape, (got.shape, want.shape)
    return got, want


def _close(got, want, tol=TOL):
    if got.dtype == np.bool_ or np.issubdtype(got.dtype, np.integer):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def _inputs(fn, rng, shape=(4, 6)):
    if fn in ("log", "sqrt", "rsqrt"):
        return rng.uniform(0.1, 3.0, shape).astype(np.float32)
    if fn == "reciprocal":
        return (rng.uniform(0.1, 3.0, shape) * rng.choice([-1, 1], shape)).astype(np.float32)
    if fn == "not":
        return rng.rand(*shape) > 0.5
    return rng.uniform(-3.0, 3.0, shape).astype(np.float32)


@pytest.mark.parametrize("fn", sorted(rir.ELEMENTWISE_UNARY))
def test_unary(fn, rng):
    x = _inputs(fn, rng)
    ref, port = _pair(lambda b: b.unary(fn, b.parameter("x", x.shape, x.dtype)))
    got, want = _run(ref, port, x)
    _close(got, want, TRANSCENDENTAL_TOL if fn in TRANSCENDENTAL else TOL)


@pytest.mark.parametrize("fn", sorted(rir.ELEMENTWISE_BINARY))
def test_binary(fn, rng):
    shape = (5, 7)
    if fn in ("and", "or"):
        x, y = rng.rand(*shape) > 0.5, rng.rand(*shape) > 0.5
    elif fn == "pow":
        x = rng.uniform(0.1, 3.0, shape).astype(np.float32)
        y = rng.uniform(-2.0, 2.0, shape).astype(np.float32)
    elif fn == "div":
        x = rng.uniform(-3.0, 3.0, shape).astype(np.float32)
        y = (rng.uniform(0.2, 3.0, shape) * rng.choice([-1, 1], shape)).astype(np.float32)
    else:
        x = rng.randint(-3, 4, shape).astype(np.float32) / 2
        y = rng.randint(-3, 4, shape).astype(np.float32) / 2   # many ties
    ref, port = _pair(
        lambda b: b.binary(fn, b.parameter("x", shape, x.dtype), b.parameter("y", shape, y.dtype))
    )
    got, want = _run(ref, port, x, y)
    _close(got, want, TRANSCENDENTAL_TOL if fn in TRANSCENDENTAL else TOL)


def test_max_min_propagate_nan():
    x = np.array([np.nan, 1.0, -2.0], np.float32)
    y = np.array([0.0, np.nan, 3.0], np.float32)
    for fn in ("max", "min"):
        ref, port = _pair(
            lambda b, fn=fn: b.binary(fn, b.parameter("x", (3,), np.float32), b.parameter("y", (3,), np.float32))
        )
        got, want = _run(ref, port, x, y)
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        _close(got[2:], want[2:])


def test_gelu_is_the_tanh_form():
    """jax.nn.gelu defaults to approximate=True; the erf form is 1e-4 off."""
    x = np.linspace(-3.0, 3.0, 601, dtype=np.float32)
    ref, port = _pair(lambda b: b.gelu(b.parameter("x", x.shape, np.float32)))
    got, want = _run(ref, port, x)
    _close(got, want, TRANSCENDENTAL_TOL)
    exact = F.gelu(torch.as_tensor(x)).numpy()
    assert np.abs(exact - want).max() > 1e-4


@pytest.mark.parametrize(
    "src,dst",
    [(np.float32, np.int32), (np.float32, np.bool_), (np.int32, np.float32),
     (np.bool_, np.float32), (np.int32, np.bool_)],
)
def test_convert(src, dst, rng):
    x = (rng.randint(-5, 6, (3, 8)) * 0.75).astype(src)
    ref, port = _pair(lambda b: b.convert(b.parameter("x", x.shape, src), dst))
    _close(*_run(ref, port, x))


def test_select(rng):
    p = rng.rand(4, 5) > 0.5
    t = rng.randn(4, 5).astype(np.float32)
    f = rng.randn(4, 5).astype(np.float32)
    ref, port = _pair(lambda b: b.select(
        b.parameter("p", p.shape, np.bool_), b.parameter("t", t.shape, np.float32),
        b.parameter("f", f.shape, np.float32)))
    _close(*_run(ref, port, p, t, f))


@pytest.mark.parametrize("op", ["reshape", "bitcast"])
def test_reshape(op, rng):
    x = rng.randn(4, 6, 5).astype(np.float32)
    ref, port = _pair(lambda b: getattr(b, op)(b.parameter("x", x.shape, np.float32), (24, 5)))
    _close(*_run(ref, port, x))


def test_transpose(rng):
    x = rng.randn(2, 3, 4, 5).astype(np.float32)
    ref, port = _pair(lambda b: b.transpose(b.parameter("x", x.shape, np.float32), (2, 0, 3, 1)))
    _close(*_run(ref, port, x))


@pytest.mark.parametrize(
    "in_shape,out_shape,dims",
    [((5,), (3, 5), (1,)), ((3,), (3, 4, 2), (0,)), ((3, 1), (3, 4), (0, 1)), ((), (2, 3), ())],
)
def test_broadcast(in_shape, out_shape, dims, rng):
    x = np.asarray(rng.randn(*in_shape), dtype=np.float32)
    ref, port = _pair(lambda b: b.broadcast(b.parameter("x", in_shape, np.float32), out_shape, dims))
    _close(*_run(ref, port, x))


@pytest.mark.parametrize("kind", list(rir.REDUCE_KINDS))
@pytest.mark.parametrize("dims", [(1,), (0, 2)])
def test_reduce(kind, dims, rng):
    x = rng.uniform(0.5, 1.5, (4, 6, 5)).astype(np.float32)
    ref, port = _pair(lambda b: b.reduce(b.parameter("x", x.shape, np.float32), dims, kind))
    # products and sums of 20-30 terms are accumulated in another order
    _close(*_run(ref, port, x), 2e-6)


@pytest.mark.parametrize("lhs,rhs", [((6, 5), (5, 7)), ((2, 3, 6, 5), (2, 3, 5, 4))])
def test_dot(lhs, rhs, rng):
    x = rng.randn(*lhs).astype(np.float32)
    y = rng.randn(*rhs).astype(np.float32)
    ref, port = _pair(lambda b: b.dot(b.parameter("x", lhs, np.float32), b.parameter("y", rhs, np.float32)))
    # f32 products of 5 terms summed in another order
    _close(*_run(ref, port, x, y), 2e-6)


def test_concat(rng):
    xs = [rng.randn(3, k, 4).astype(np.float32) for k in (2, 5, 1)]
    ref, port = _pair(lambda b: b.concat(
        [b.parameter(f"x{i}", x.shape, np.float32) for i, x in enumerate(xs)], dim=1))
    _close(*_run(ref, port, *xs))


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_gather(dtype, rng):
    table = (rng.randn(9, 4) * 10).astype(dtype)
    idx = rng.randint(0, 9, (3, 5)).astype(np.int32)
    ref, port = _pair(lambda b: b.gather(
        b.parameter("t", table.shape, dtype), b.parameter("i", idx.shape, np.int32)))
    _close(*_run(ref, port, table, idx))


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_gather_out_of_range_fills_like_jnp_take(dtype, rng):
    """jnp.take's default mode wraps [-n, 0) and fills the rest."""
    table = (rng.randn(4, 3) * 10).astype(dtype)
    idx = np.array([0, -1, 4, -5, 3, 100], np.int32)
    ref, port = _pair(lambda b: b.gather(
        b.parameter("t", table.shape, dtype), b.parameter("i", idx.shape, np.int32)))
    got, want = _run(ref, port, table, idx)
    if dtype == np.float32:
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        got, want = np.nan_to_num(got), np.nan_to_num(want)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("dim", [0, 1])
def test_iota(dtype, dim):
    ref, port = _pair(lambda b: b.iota((3, 4), dim=dim, dtype=dtype))
    _close(*_run(ref, port))


@pytest.mark.parametrize("value", [np.float32(0.1), np.arange(6, dtype=np.int32).reshape(2, 3)])
def test_constant(value):
    ref, port = _pair(lambda b: b.constant(value))
    _close(*_run(ref, port))


def test_loops_and_collectives_name_their_roadmap_item(tmp_path):
    import torch.distributed as dist

    b = tir.GraphBuilder("c")
    x = b.parameter("x", (4,), np.float32)
    ar = b.all_reduce(x, "d")
    # a collective runs in a torch.distributed world and names itself without one
    with pytest.raises(RuntimeError, match=f"{ar.instr.name}.*no process group"):
        tir.apply_op(ar.instr, torch.zeros(4))
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        v = torch.arange(4, dtype=torch.float32)
        assert torch.equal(tir.apply_op(ar.instr, v), v)
        ag = b.all_gather(x, "d", dim=0, group_size=1)
        assert torch.equal(tir.apply_op(ag.instr, v), v)
    finally:
        dist.destroy_process_group()
    # the verifier is ported: Module.verify runs, and rejects a broken module
    clean = tir.GraphBuilder("v")
    y = clean.parameter("y", (4,), np.float32)
    clean.exp(y)
    clean.module.verify()
    clean.module.instructions[-1].shape = (5,)
    with pytest.raises(ValueError, match="IR005"):
        clean.module.verify()


def test_infer_shape_and_dtype_match_the_reference_on_every_graph():
    from repro_torch.graphs import ALL_GRAPHS

    for build in ALL_GRAPHS.values():
        for i in build().instructions:
            shapes = [o.shape for o in i.operands]
            dtypes = [o.dtype for o in i.operands]
            shape = tir.infer_shape(i.opcode, shapes, i.attrs)
            dtype = tir.infer_dtype(i.opcode, dtypes, i.attrs)
            assert shape == rir.infer_shape(i.opcode, shapes, i.attrs)
            assert dtype == rir.infer_dtype(i.opcode, dtypes, i.attrs)
            assert shape is None or shape == i.shape, i
            assert dtype is None or dtype == i.dtype, i


def test_trace_builds_what_the_reference_traces():
    def fn(b, x, g):
        return b.softmax(x * b.broadcast(g, x.shape, (1,)))

    specs = (("x", (4, 8), np.float32), ("g", (8,), np.float32))
    port = tir.trace(fn, *specs, name="t")
    ref = rir.trace(fn, *specs, name="t")
    assert [(i.opcode, i.shape, i.dtype, i.attrs.get("fn")) for i in port.instructions] == [
        (i.opcode, i.shape, i.dtype, i.attrs.get("fn")) for i in ref.instructions
    ]
    assert [p.name for p in port.parameters] == ["x", "g"]
