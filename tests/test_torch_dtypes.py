"""bf16, f16, int8 and uint8 through the port, held against the reference.

The same module and the same seeded numpy inputs go through the JAX
package's ``compile_module`` (its Pallas kernels in interpret mode on the
CPU) and the port's ``compile_module(..., device="cpu")`` (each kernel's
plain version).  Integers wrap as numpy does and agree exactly.  The port
rounds every instruction's value to its dtype, as the reference's
``reference_execute`` does, and its elementwise results equal that oracle's
exactly.  The reference's interpreted kernel does not always: inside one of
its fusions XLA may keep a bf16 product in f32 before the convert (measured:
0.015625 on values near 4, one bf16 ulp).  A bf16 or f16 sum accumulates in
f32 and rounds once in the port (as ``torch.sum`` does); the reference's
kernel lands up to one ulp away (measured: 1.0 on bf16 sums near 218, whose
ulp is 1.0).  So float results are held against the reference's kernel, and
reduces against its oracle, at one ulp: 2**-7 of the value in bf16 and
2**-10 in f16.  The CUDA text of each kernel
is built and run against its plain version on the card by
``chip_smoke.py``; here the types and literals it prints are checked.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import StitchOptions as RefOptions
from repro.core import compile_module as ref_compile
from repro.core import ir as rir
from repro.core import reference_execute as ref_execute
from repro.core import trace as ref_trace
from repro_torch.core import StitchOptions, codegen, compile_module, geometry
from repro_torch.core import ir as tir
from repro_torch.core.interop import module_from_reference

BF16 = np.dtype(jnp.bfloat16)
DTYPES = {"bfloat16": BF16, "float16": np.dtype(np.float16),
          "int8": np.dtype(np.int8), "uint8": np.dtype(np.uint8), "int16": np.dtype(np.int16)}
# one unit in the last place, relative: what a sum rounded once may move
ULP = {"bfloat16": 2.0 ** -7, "float16": 2.0 ** -10}


def _arith(b, x, y):
    """An add, a mul, a row reduce and a convert."""
    s = (x + y) * y
    return b.reduce(s, (1,), "sum"), b.reduce(s, (1,), "max"), b.convert(s, jnp.float32)


def _inputs(dtype, rng, shape):
    if dtype.kind in "iu":
        lo = -60 if dtype.kind == "i" else 0
        return rng.randint(lo, 120, shape).astype(dtype)   # sums and products wrap
    return rng.uniform(-2, 2, shape).astype(dtype)


def _as_numpy(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


@pytest.mark.parametrize("name", list(DTYPES))
def test_module_in_each_dtype_matches_reference(name, rng):
    dtype = DTYPES[name]
    ref_module = ref_trace(_arith, ("x", (64, 128), dtype), ("y", (64, 128), dtype))
    feeds = {"x": _inputs(dtype, rng, (64, 128)), "y": _inputs(dtype, rng, (64, 128))}
    carried = module_from_reference(ref_module)
    port = compile_module(carried, device="cpu")
    assert {k.fn.emitter for k in port.kernels} == {"emit_fusion"}
    got = port(feeds)
    want = ref_compile(ref_module, RefOptions())(feeds)
    oracle = ref_execute(ref_module, feeds)
    assert got.keys() == want.keys() == {r.name for r in carried.roots}
    for r in carried.roots:
        k = r.name
        assert got[k].dtype == tir.torch_dtype(r.dtype)
        g, w = _as_numpy(got[k]), np.asarray(want[k])
        if dtype.kind in "iu":
            np.testing.assert_array_equal(g, w, err_msg=f"{name}:{k}")   # both wrap
        else:
            np.testing.assert_allclose(g, w.astype(np.float32), rtol=ULP[name], atol=0, err_msg=f"{name}:{k}")
        o = np.asarray(oracle[k])
        if dtype.kind in "iu":
            # the reference's oracle sums in int32 and never wraps; modulo 2**8 it agrees
            np.testing.assert_array_equal(g.astype(np.int64) % 256, o.astype(np.int64) % 256)
        elif r.opcode == "reduce":
            np.testing.assert_allclose(g, o.astype(np.float32), rtol=ULP[name], atol=0)
        else:
            np.testing.assert_array_equal(g, o.astype(g.dtype))


def _softmax_transpose(b, x, g):
    """tests/test_stitching.py's break module (see test_torch_codegen.py)."""
    scaled = x * b.broadcast(g, x.shape, (1,))
    mx = b.reduce(scaled, (1,), "max")
    e = b.exp(scaled - b.broadcast(mx, x.shape, (0,)))
    s = b.reduce(e, (1,), "sum")
    p = e / b.broadcast(s, x.shape, (0,))
    t = b.transpose(p, (1, 0))
    return b.tanh(t) * 0.5


def test_stitched_module_in_bf16_matches_reference(rng):
    """A bf16 softmax feeding a transpose takes the stitched path.  exp and
    tanh in f32 sit a few f32 ulp apart in the two packages, which can tip
    a bf16 rounding: held at one bf16 ulp (2**-7), plus 2**-12 near 0."""
    opts = {"max_blocks": 32, "replicate_limit": 1024}
    ref_module = ref_trace(_softmax_transpose, ("x", (32, 48), BF16), ("g", (48,), BF16))
    feeds = {"x": rng.uniform(-3, 3, (32, 48)).astype(BF16), "g": rng.uniform(-1, 1, (48,)).astype(BF16)}
    port = compile_module(module_from_reference(ref_module), StitchOptions(**opts), device="cpu")
    assert [k.fn.emitter for k in port.kernels] == ["emit_stitched_fusion"]
    got = port(feeds)
    want = ref_compile(ref_module, RefOptions(**opts))(feeds)
    for k in want:
        assert got[k].dtype == torch.bfloat16
        np.testing.assert_allclose(_as_numpy(got[k]), np.asarray(want[k]).astype(np.float32),
                                   rtol=ULP["bfloat16"], atol=2.0 ** -12, err_msg=k)


def test_module_from_reference_carries_bf16():
    ref_module = ref_trace(lambda b, x: b.exp(x) * 3.0 + x, ("x", (4, 8), BF16))
    carried = module_from_reference(ref_module)
    for r, c in zip(ref_module.instructions, carried.instructions, strict=True):
        assert c.dtype == tir.BFLOAT16 and isinstance(c.dtype, np.dtype)
        assert tir.torch_dtype(c.dtype) == torch.bfloat16
        assert tir.dtype_name(c.dtype) == "bfloat16" == np.dtype(r.dtype).name
        if c.opcode == "constant":
            assert c.attrs["value"].dtype == np.float32
            np.testing.assert_array_equal(c.attrs["value"], np.asarray(r.attrs["value"]).astype(np.float32))
    assert "bfloat16[4, 8]" in repr(carried)
    x = rir.GraphBuilder("y").parameter("x", (2,), BF16)
    assert np.dtype(x.dtype).itemsize == tir.BFLOAT16.itemsize == 2


@pytest.mark.parametrize("name", list(DTYPES))
def test_c_types_and_literals_carry_every_bit(name):
    dtype = DTYPES[name]
    port_dtype = tir.BFLOAT16 if name == "bfloat16" else dtype
    storage = {"bfloat16": "__nv_bfloat16", "float16": "__half",
               "int8": "signed char", "uint8": "unsigned char", "int16": "short"}[name]
    assert codegen._c_type(port_dtype) == storage
    assert geometry._c_compute(port_dtype) == ("int" if dtype.kind in "iu" else "float")
    values = [0, 1, -1, 100, -128, 127, 255] if dtype.kind in "iu" else \
        [0.0, -0.0, 1.0, 0.1, -3.140625, 65504.0, 1e-3, np.inf, -np.inf, np.nan]
    for v in values:
        want = np.asarray(v).astype(dtype)   # numpy's (ml_dtypes') rounding and wrap
        lit = codegen._c_literal(want if dtype.kind in "iu" else v, port_dtype)
        if dtype.kind in "iu":
            assert lit == f"static_cast<{storage}>({int(want)})"
            continue
        fn = "__ushort_as_bfloat16" if name == "bfloat16" else "__ushort_as_half"
        assert lit.startswith(f"{fn}(static_cast<unsigned short>(0x")
        bits = int(lit.split("0x")[1].rstrip(")"), 16)
        assert bits == int(want.view(np.uint16)), (v, lit)
    # values round to the dtype where a member ends, computed in float / int
    assert codegen._c_round(port_dtype, "x") == codegen._c_load(port_dtype, codegen._c_store(port_dtype, "x"))


@pytest.mark.parametrize("dtype", [np.int8, np.uint8, np.int16, np.int32])
def test_convert_from_float_saturates_like_jnp(dtype):
    x = np.array([300.0, -300.0, 127.7, -128.9, 1e10, np.nan, np.inf, -np.inf, 2.5, -2.5], np.float32)
    b = rir.GraphBuilder("c")
    out = b.convert(b.parameter("x", x.shape, np.float32), dtype)
    port = module_from_reference(b.module)
    twin = next(i for i in port.instructions if i.id == out.instr.id)
    want = np.asarray(rir.apply_op(out.instr, jnp.asarray(x)))
    got = tir.apply_op(twin, torch.as_tensor(x)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", [np.int8, np.uint8, np.int16])
def test_gather_fills_small_int_rows_like_jnp_take(dtype):
    """jnp.take fills signed rows with the smallest value, unsigned rows
    with the largest."""
    table = np.arange(12).reshape(4, 3).astype(dtype)
    idx = np.array([0, -1, 4, -5, 3, 100], np.int32)
    b = rir.GraphBuilder("g")
    out = b.gather(b.parameter("t", table.shape, dtype), b.parameter("i", idx.shape, np.int32))
    port = module_from_reference(b.module)
    twin = next(i for i in port.instructions if i.id == out.instr.id)
    want = np.asarray(rir.apply_op(out.instr, jnp.asarray(table), jnp.asarray(idx)))
    got = tir.apply_op(twin, torch.as_tensor(table), torch.as_tensor(idx)).numpy()
    np.testing.assert_array_equal(got, want)


def _int_break(b, x, g):
    """The break module's integer kin: a row max feeding a transpose."""
    s = x * b.broadcast(g, x.shape, (1,))
    d = s - b.broadcast(b.reduce(s, (1,), "max"), x.shape, (0,))
    t = b.transpose(d, (1, 0))
    return t + t


def test_stitched_module_in_int8_matches_reference(rng):
    """int8 through the stitched path wraps exactly as the reference does."""
    opts = {"max_blocks": 32, "replicate_limit": 1024}
    int8 = np.dtype(np.int8)
    ref_module = ref_trace(_int_break, ("x", (32, 48), int8), ("g", (48,), int8))
    feeds = {"x": _inputs(int8, rng, (32, 48)), "g": _inputs(int8, rng, (48,))}
    port = compile_module(module_from_reference(ref_module), StitchOptions(**opts), device="cpu")
    assert [k.fn.emitter for k in port.kernels] == ["emit_stitched_fusion"]
    got = port(feeds)
    want = ref_compile(ref_module, RefOptions(**opts))(feeds)
    for k in want:
        assert got[k].dtype == torch.int8
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
