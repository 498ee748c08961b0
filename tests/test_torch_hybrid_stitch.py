"""A Mamba-2 layer through ``repro_torch.stitch``: the frontend's window ops,
the IR's ``slice`` and ``cumsum``, and the hybrid layer of
``stitchbench/programs/hybrid_layer.py`` against its plain reference.

* Each lowering of ``frontend/aten_lower.py`` ``SEQUENCE_OPS`` (slices,
  ``select``, ``split_with_sizes``, ``constant_pad_nd``, the depthwise
  ``convolution``, ``cumsum``, ``bitwise_not``) and ``log1p``, through
  ``stitch(device="cpu")``, against eager torch; what does not lower raises
  ``UnsupportedPrimitiveError``.
* ``apply_op`` of ``cumsum``, ``slice`` and ``log1p`` against torch.
* The card's plan (``H100``) read on the CPU: a running sum is one thread
  walking each row, a slice an offset index.
* The hybrid layer of both kinds at a small size, the chunked SSD against
  the reference's sequential recurrence, and the tracer's ``lower.<op>``,
  ``codegen.cumsums`` and the ``compile`` span's ``kernels`` read back.

On the card, ``PYTHONPATH=src python -m pytest -q --noconftest -m card
tests/test_torch_hybrid_stitch.py``: both plans of the layer replay as one
CUDA graph each, with no fallback, and equal the plain function.
"""
import json
import re
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from repro_torch import stitch, tracing
from repro_torch.core import StitchOptions
from repro_torch.core.ir import GraphBuilder, apply_op
from repro_torch.core.latency import H100
from repro_torch.core.schedule import COLUMN, ROW, Sched, Unsatisfiable, propagate
from repro_torch.frontend.aten_lower import UnsupportedPrimitiveError

#: float32 rounding of these small functions: the plain kernels compute
#: each op as torch does, but compose and reassociate some (a tap sum, a
#: running sum walked in order)
TOL = 2e-5


def _cpu(fn):
    return stitch(fn, device="cpu")


def _close(got, want):
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        torch.testing.assert_close(g, w, rtol=TOL, atol=TOL)


# ---------------------------------------------------------------------------
# each lowering against eager torch
# ---------------------------------------------------------------------------

def _conv(pad):
    def f(x, w, b):
        return F.conv1d(x, w, b, padding=pad, groups=x.shape[1])
    return f


LOWERINGS = {
    "slice": (lambda x: x[:, 2:9:3] * 2.0, [(5, 12)]),
    "slice_negative": (lambda x: x[..., -4:] + x[..., :4], [(3, 6, 10)]),
    "slice_of_transpose": (lambda x: x.transpose(0, 1)[1:4] + 1.0, [(6, 5)]),
    "select": (lambda x: x[:, 3] - x[1], [(6, 6)]),
    "split_with_sizes": (lambda x: torch.split(x * 3.0, [2, 5, 1], dim=-1), [(4, 8)]),
    "pad": (lambda x: F.pad(x, (1, 2)) * 2.0, [(3, 5)]),
    "pad_two_dims_and_negative": (lambda x: F.pad(x, (2, -1, -1, 3), value=0.5), [(4, 6)]),
    "conv_causal": (lambda x, w, b: _conv(3)(x, w, b)[..., :x.shape[-1]], [(2, 6, 9), (6, 1, 4), (6,)]),
    "conv_unpadded": (lambda x, w, b: _conv(0)(x, w, b), [(1, 5, 8), (5, 1, 3), (5,)]),
    "conv_no_bias": (lambda x, w: F.conv1d(x, w, padding=1, groups=4), [(2, 4, 7), (4, 1, 3)]),
    "cumsum_last": (lambda x: torch.cumsum(x, dim=-1), [(6, 20)]),
    "cumsum_middle": (lambda x: torch.cumsum(x * 0.5, dim=1) + 1.0, [(3, 9, 4)]),
    "cumsum_of_masked": (lambda x: torch.cumsum(x.masked_fill(~torch.tril(torch.ones(
        5, 5, dtype=torch.bool)), 0.0), dim=-2), [(2, 5, 5)]),
    "log1p": (lambda x: torch.log1p(torch.exp(x)), [(4, 16)]),
    "softplus": (lambda x: F.softplus(x * 30.0), [(4, 16)]),
    "bitwise_not": (lambda x: torch.where(~(x > 0), x, -x), [(3, 8)]),
}


@pytest.mark.parametrize("case", list(LOWERINGS))
def test_lowering_matches_eager(case):
    fn, shapes = LOWERINGS[case]
    gen = torch.Generator().manual_seed(sum(map(ord, case)))
    args = [torch.randn(s, generator=gen) for s in shapes]
    sf = _cpu(fn)
    _close(sf(*args), fn(*args))
    assert sf.num_fallbacks == 0


@pytest.mark.parametrize("case", ["strided", "dilated", "grouped", "int_not"])
def test_what_does_not_lower_raises_naming_the_op(case):
    x = torch.randn(2, 4, 8)
    fns = {
        "strided": (lambda x, w: F.conv1d(x, w, stride=2, groups=4), (x, torch.randn(4, 1, 3))),
        "dilated": (lambda x, w: F.conv1d(x, w, dilation=2, groups=4), (x, torch.randn(4, 1, 3))),
        "grouped": (lambda x, w: F.conv1d(x, w, groups=2), (x, torch.randn(4, 2, 3))),
        "int_not": (lambda x: ~(x > 0).to(torch.int32), (x,)),
    }
    fn, args = fns[case]
    op = "aten.bitwise_not.default" if case == "int_not" else "aten.convolution.default"
    with pytest.raises(UnsupportedPrimitiveError, match=re.escape(op)):
        _cpu(fn)(*args)


def test_an_identity_slice_emits_nothing():
    lowered = _cpu(lambda x: x[:, :] * 2.0).lower(torch.randn(3, 4))
    assert not any(i.opcode == "slice" for i in lowered.module.instructions)


def test_a_depthwise_conv_lowers_to_one_slice_a_tap():
    fn, shapes = LOWERINGS["conv_causal"]
    lowered = _cpu(fn).lower(*[torch.randn(s) for s in shapes])
    ops = [i.opcode for i in lowered.module.instructions]
    # four taps of the padded input and four weight columns, the causal cut
    assert ops.count("slice") == 4 + 4 + 1 and "concat" in ops


# ---------------------------------------------------------------------------
# the IR's plain semantics and the schedule rules
# ---------------------------------------------------------------------------

def _one(op, shape, **attrs):
    b = GraphBuilder()
    x = b.parameter("x", shape)
    out = {"cumsum": lambda: b.cumsum(x, attrs["dim"]), "log1p": lambda: b.unary("log1p", x),
           "slice": lambda: b.slice(x, attrs["starts"], attrs["limits"], attrs["strides"])}[op]()
    return out.instr


@pytest.mark.parametrize("dim", [0, 1, 2])
def test_apply_op_cumsum_is_torchs(dim):
    x = torch.randn(3, 4, 5)
    assert torch.equal(apply_op(_one("cumsum", (3, 4, 5), dim=dim), x), torch.cumsum(x, dim))


def test_apply_op_log1p_is_torchs_not_log_of_one_plus():
    x = torch.tensor([1e-8, 1e-3, 0.05, 3.0])
    got = apply_op(_one("log1p", (4,)), x)
    assert torch.equal(got, torch.log1p(x))
    assert got[0] != torch.log(1 + x)[0]


def test_apply_op_slice_and_its_shape():
    instr = _one("slice", (7, 9), starts=(1, 0), limits=(7, 9), strides=(2, 1))
    assert instr.shape == (3, 9)
    x = torch.randn(7, 9)
    assert torch.equal(apply_op(instr, x), x[1:7:2])


@pytest.mark.parametrize("op, sched, ok", [
    ("cumsum", Sched("chunked", 0, 2, ROW), True),
    ("cumsum", Sched("chunked", 1, 2, ROW), False),
    ("cumsum", Sched("chunked", 2, 2, COLUMN), True),
    ("slice", Sched("chunked", 0, 4, ROW), True),
    ("slice", Sched("chunked", 1, 3, COLUMN), False),
])
def test_a_block_holds_the_dim_it_reads_across_whole(op, sched, ok):
    instr = (_one("cumsum", (4, 6, 8), dim=1) if op == "cumsum"
             else _one("slice", (4, 6, 8), starts=(0, 1, 0), limits=(4, 5, 8), strides=(1, 1, 1)))
    if ok:
        assert propagate(instr, sched) == [sched]
    else:
        with pytest.raises(Unsatisfiable):
            propagate(instr, sched)


@pytest.mark.parametrize("attrs, bad", [
    ({"starts": (0, 1, 0), "limits": (4, 5, 8), "strides": (1, 1, 1)}, False),
    ({"starts": (0, 5, 0), "limits": (4, 9, 8), "strides": (1, 1, 1)}, True),
    ({"dim": 1}, False),
    ({"dim": 3}, True),
])
def test_the_verifier_holds_a_window_inside_its_operand(attrs, bad):
    from repro_torch.core.verify import verify_module

    op = "cumsum" if "dim" in attrs else "slice"
    good = ({"dim": 1} if op == "cumsum"
            else {"starts": (0, 1, 0), "limits": (4, 5, 8), "strides": (1, 1, 1)})
    instr = _one(op, (4, 6, 8), **good)
    instr.attrs.update(attrs)
    module = GraphBuilder().module
    module.instructions[:] = [instr.operands[0], instr]
    rules = {d.rule for d in verify_module(module)}
    assert ("IR007" in rules) == bad


# ---------------------------------------------------------------------------
# the card's text, read here
# ---------------------------------------------------------------------------

def _h100_sources(fn, *args):
    cm = stitch(fn, options=StitchOptions(device_spec=H100), device="cpu").lower(*args).compile()
    return [k.fn.source for k in cm.kernels]


def test_a_running_sum_is_one_thread_walking_its_row():
    tracing.reset()
    (src,) = _h100_sources(lambda x: torch.cumsum(x, dim=-1), torch.randn(64, 300))
    assert re.search(r"for \(int r = 0; r < 300; \+\+r\) \{", src)
    assert "acc += in0[o0 * 300 + r];" in src and "out0[o0 * 300 + r] = v;" in src
    assert tracing.snapshot().counters["codegen.cumsums"] == 1


def test_a_slice_reads_its_operand_at_an_offset():
    (src,) = _h100_sources(lambda x: x[:, 5:29:3] * 2.0, torch.randn(16, 40))
    assert re.search(r"in0\[[^\]]*\(5 \+ [a-z0-9]+ \* 3\)\]", src), src


# ---------------------------------------------------------------------------
# the hybrid layer against the plain reference
# ---------------------------------------------------------------------------

#: granite-4.0-h-micro's layer at a small size: the published ratios of
#: heads, the inner width twice the model's, one group of B and C
SMALL = dict(hidden_size=32, num_attention_heads=4, num_key_value_heads=1, head_dim=8,
             intermediate_size=48, mamba_n_heads=4, mamba_d_head=16, mamba_d_state=8,
             mamba_chunk_size=4, layer_types=["mamba", "attention"], layers_held=[0, 2],
             num_hidden_layers=2)
#: ``out_err`` of the stitched layer: the program runs the chunked SSD and
#: the reference the sequential recurrence, which sum the state's terms in
#: other orders; in float32 at these widths that is a few ulps of the
#: output over the stack's change to ``x`` (1e-6 read), far under what
#: rounding the products to TF32 would give (1e-3 at full width on the card)
HYBRID_TOL = 2e-5


def _hybrid_cell():
    import sys

    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    from stitchbench.programs import hybrid_layer as program
    from stitchbench.reference import hybrid_layer as reference

    cfg = json.loads((Path(root) / "stitchbench/configs/granite-4.0-h-micro.json").read_text())
    return dict(cfg, **SMALL), program, reference


def test_hybrid_layer_of_both_kinds_matches_the_sequential_reference():
    cfg, program, reference = _hybrid_cell()
    batch, seq = 2, 12
    layers, (cos, sin), xs = program.make_inputs(cfg, batch, seq, 2**31 + 11, 1,
                                                 torch.device("cpu"))
    assert [("w_in" in w) for w in layers] == [True, False]
    tracing.reset()
    # the card's plan, run by the plain kernels
    sf = stitch(program.build(cfg, batch, seq), options=StitchOptions(device_spec=H100),
                device="cpu")
    x = xs[0]
    for w in layers:
        x = sf(x, *w.values(), cos, sin)
    want = reference.forward(cfg, program.shape(cfg), seq, layers, xs[0], cos, sin)
    err = float((x - want).abs().max() / (want - xs[0]).abs().max())
    assert err < HYBRID_TOL
    assert sf.num_fallbacks == 0 and sf.num_compiles == 2
    snap = tracing.snapshot()
    for op in ("convolution", "slice", "split_with_sizes", "constant_pad_nd", "cumsum",
               "log1p", "bitwise_not", "select"):
        assert snap.counters[f"lower.{op}"] >= 1, op
    assert snap.counters["codegen.cumsums"] >= 3
    compiles = [s for s in snap.spans if s.name == "compile"]
    assert [s.attrs["arguments"] for s in compiles] == [1 + len(program.MAMBA_WEIGHTS) + 2,
                                                        1 + len(program.ATTENTION_WEIGHTS) + 2]
    for s, plan in zip(compiles, sf._plans.values()):
        assert s.attrs["kernels"] == [k.fn.symbol for k in plan.compiled.kernels]
        assert all(re.fullmatch(r"stitch_[0-9a-f]{16}_\w+", k) for k in s.attrs["kernels"])


def test_the_chunked_ssd_is_causal():
    """A later token changes no earlier output of the Mamba-2 layer."""
    cfg, program, _ = _hybrid_cell()
    seq = 8
    layers, (cos, sin), (x,) = program.make_inputs(cfg, 1, seq, 5, 1, torch.device("cpu"))
    fn = program.build(cfg, 1, seq)
    base = fn(x, *layers[0].values(), cos, sin)
    moved = x.clone()
    moved[5] += 1.0
    after = fn(moved, *layers[0].values(), cos, sin)
    assert torch.equal(base[:5], after[:5]) and not torch.equal(base[5:], after[5:])


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card")
    return torch.device("cuda", 0)


@pytest.mark.card
def test_both_plans_replay_their_cuda_graph_on_the_card(card):
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, program, _ = _hybrid_cell()
    batch, seq = 1, 64
    layers, (cos, sin), (x,) = program.make_inputs(cfg, batch, seq, 9, 1, card)
    fn = program.build(cfg, batch, seq)
    sf = stitch(fn)
    for w in layers:
        got = sf(x, *w.values(), cos, sin)
        want = fn(x, *w.values(), cos, sin)
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
        assert sf.num_fallbacks == 0 and sf.stats.replay_mode == "graph"
    assert sf.num_compiles == 2
    assert all(p.compiled.executable.replay_mode == "graph" for p in sf._plans.values())
