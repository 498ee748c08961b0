"""A Gated DeltaNet layer through ``repro_torch.stitch``: the frontend's
writes into slices and rows, and the hybrid layer of
``stitchbench/programs/gated_deltanet_layer.py`` against its plain
reference.

* Each lowering this layer added to ``frontend/aten_lower.py`` (``t[..., i,
  :i] = v`` as ``slice_scatter`` and ``select_scatter`` over the functional
  ``copy``, and the ``select_copy`` of a ``scan`` body), through
  ``stitch(device="cpu")``, against eager torch, each ticking its
  ``lower.<op>`` counter.
* The chunked delta rule run eagerly against the reference's recurrence one
  position at a time, so that an error of the mathematics is told apart
  from an error of the compiler.
* The stack of both kinds of layer at a small size through the card's plan
  (``H100``, run by the plain kernels) against the reference, the
  ``compile`` spans naming the loop body's kernels.

On the card, ``PYTHONPATH=src python -m pytest -q --noconftest -m card
tests/test_torch_gated_deltanet.py``: both plans equal the plain function,
with no fallback, and the linear plan replays as one CUDA graph.
"""
import json
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch._higher_order_ops.scan import scan

from repro_torch import stitch, tracing
from repro_torch.core import StitchOptions
from repro_torch.core.fusion import FusedComputation, _break_cycles, _cycle_through, _group_cycle
from repro_torch.core.ir import GraphBuilder
from repro_torch.core.latency import H100
from repro_torch.core.memory import COMPOSE_LIMIT, INLINE, plan_memory
from repro_torch.core.schedule import REPLICATED, resolve_schedules
from repro_torch.core.verify import verify_fusion_groups
from repro_torch.frontend.aten_lower import UnsupportedPrimitiveError

ROOT = Path(__file__).resolve().parents[1]
#: float32 rounding of these small functions
TOL = 2e-5
#: the configuration at small widths: full attention 4 heads x 8, the
#: linear layers 2 heads with keys of 8 and values of 16, chunks of 4; a
#: Gated DeltaNet layer and a full-attention layer
SMALL = dict(hidden_size=32, num_attention_heads=4, num_key_value_heads=4, head_dim=8,
             intermediate_size=48, linear_num_key_heads=2, linear_num_value_heads=2,
             linear_key_head_dim=8, linear_value_head_dim=16, chunk_size=4,
             layer_types=["linear_attention", "full_attention"], layers_held=[0, 2],
             num_hidden_layers=2)
#: ``out_err`` of the stitched stack against the recurrence: a few ulps of
#: the output over the stack's change to ``x``
STACK_TOL = 2e-5


def _cell():
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from stitchbench.programs import gated_deltanet_layer as program
    from stitchbench.reference import gated_deltanet_layer as reference

    cfg = json.loads((ROOT / "stitchbench/configs/olmo-hybrid-7b.json").read_text())
    return dict(cfg, **SMALL), program, reference


# ---------------------------------------------------------------------------
# each new lowering against eager torch
# ---------------------------------------------------------------------------

def _rows(x):
    """The forward substitution's in-place row writes, as users write them."""
    a = x.clone()
    for i in range(1, a.shape[-1]):
        row = a[..., i, :i].clone()
        sub = a[..., :i, :i].clone()
        a[..., i, :i] = row + (row.unsqueeze(-1) * sub).sum(-2)
    return a


def _row_write(x, v):
    y = x * 2.0
    y[:, 2] = v
    return y


def _window_write(x, v):
    y = x + 1.0
    y[1:3, :, 2:5] = v
    return y


def _scan_rows(x):
    def step(carry, xs):
        (rows,) = xs
        return carry + rows[0] * 2.0, carry * rows[2]

    last, ys = scan(step, x[0, 1], [x[1:]])
    return last, ys


LOWERINGS = {
    "forward_substitution": (_rows, [(2, 5, 5)],
                             ("slice_scatter", "select_scatter", "copy")),
    "row_write": (_row_write, [(4, 5), (4,)], ("select_scatter",)),
    "window_write": (_window_write, [(4, 3, 6), (2, 3, 3)], ("slice_scatter", "copy")),
    "scan_rows": (_scan_rows, [(5, 3, 4)], ("select_copy",)),
}


@pytest.mark.parametrize("case", list(LOWERINGS))
def test_lowering_matches_eager_and_is_counted(case):
    fn, shapes, ops = LOWERINGS[case]
    gen = torch.Generator().manual_seed(sum(map(ord, case)))
    args = [torch.randn(s, generator=gen) for s in shapes]
    tracing.reset()
    sf = stitch(fn, device="cpu")
    got, want = sf(*args), fn(*args)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want, strict=True):
        assert g.shape == w.shape
        torch.testing.assert_close(g, w, rtol=TOL, atol=TOL)
    assert sf.num_fallbacks == 0
    counters = tracing.snapshot().counters
    for op in ops:
        assert counters.get(f"lower.{op}", 0) >= 1, op


def test_a_strided_write_raises_naming_the_op():
    def f(x, v):
        y = x * 2.0
        y[:, ::2] = v
        return y

    with pytest.raises(UnsupportedPrimitiveError, match=re.escape("aten.slice_scatter.default")):
        stitch(f, device="cpu")(torch.randn(3, 6), torch.randn(3, 3))


# ---------------------------------------------------------------------------
# the planner's repairs this layer needed
# ---------------------------------------------------------------------------

def _crossed_groups():
    """Two groups that each read what the other writes: A = {a1, a2}, B =
    {b1, b2}, with b2 reading a1 and a2 reading b1.  Neither group reaches
    itself through outside instructions, but each kernel runs after every
    input of every member, so neither can run first."""
    b = GraphBuilder("crossed")
    x = b.parameter("x", (8,), np.float32)
    a1, b1 = b.tanh(x), b.square(x)
    b2, a2 = b.tanh(a1), b.square(b1)
    fa = FusedComputation(members=[a1.instr, a2.instr], name="A")
    fb = FusedComputation(members=[b1.instr, b2.instr], name="B")
    return b.module, fa, fb


def test_groups_that_read_each_other_are_split_until_the_plan_is_acyclic():
    m, fa, fb = _crossed_groups()
    assert _group_cycle(set(fa.members)) is False
    assert _cycle_through([fa, fb], []) is not None
    assert "PLAN001" in {d.rule for d in verify_fusion_groups([fa, fb], [], m)}
    fused = _break_cycles([fa, fb], [], None)
    assert _cycle_through(fused, []) is None
    assert sorted(len(f.members) for f in fused) == [1, 1, 2]
    assert verify_fusion_groups(fused, [], m) == []


def _concat_of_chain(links):
    """A concat read twice, of a chain of ``links`` negations and ``x``."""
    b = GraphBuilder("chain")
    x = b.parameter("x", (4, 8), np.float32)
    t = x
    for _ in range(links):
        t = b.unary("neg", t)
    c = b.concat([t, x], 0)
    y = b.binary("add", c, b.unary("neg", c))
    members = [i for i in b.module.instructions if i.opcode != "parameter"]
    sol = resolve_schedules(members, [y.instr], {y.instr.id: REPLICATED})
    return plan_memory(members, [y.instr], sol, 1 << 22).action(c.instr)


def test_a_group_every_member_of_which_the_cycle_reaches_splits_into_its_members():
    """A = {a1, a2} between B = {b1, b2} and C = {c1, c2}: b2 reads a1, a2
    reads b1, c2 reads a2, a1 reads c1.  Every member of A is reached from
    A through the other groups, so A splits into its members; then B
    splits, and the plan runs C's c1, a1, b2 after b1, a2, c2's group."""
    b = GraphBuilder("three")
    x = b.parameter("x", (8,), np.float32)
    c1, b1 = b.tanh(x), b.square(x)
    a1, a2 = b.tanh(c1), b.square(b1)
    b2, c2 = b.tanh(a1), b.square(a2)
    groups = [FusedComputation(members=[p.instr, q.instr], name=n)
              for n, p, q in (("A", a1, a2), ("B", b1, b2), ("C", c1, c2))]
    m = b.module
    fused = _break_cycles(groups, [], None)
    assert _cycle_through(fused, []) is None
    assert verify_fusion_groups(fused, [], m) == []
    assert sorted(len(f.members) for f in fused) == [1, 1, 1, 1, 2]


def test_a_value_composed_of_many_members_and_read_twice_takes_a_slot():
    """Each reader of an inlined value composes its whole expression: a
    chain of such values (rows written into a matrix whose earlier rows
    each row reads) would grow the kernel's text exponentially."""
    assert _concat_of_chain(COMPOSE_LIMIT // 2) == INLINE
    assert _concat_of_chain(COMPOSE_LIMIT) != INLINE


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------

def test_the_chunked_program_matches_the_recurrence_eagerly():
    cfg, program, reference = _cell()
    batch, seq = 2, 12
    layers, (cos, sin), (x,) = program.make_inputs(cfg, batch, seq, 2**31 + 3, 1,
                                                   torch.device("cpu"))
    fn = program.build(cfg, batch, seq)
    y = x
    for w in layers:
        y = fn(y, *w.values(), cos, sin)
    want = reference.forward(cfg, program.shape(cfg), seq, layers, x, cos, sin)
    assert float((y - want).abs().max() / (want - x).abs().max()) < STACK_TOL


def test_the_recurrence_is_the_delta_rule():
    """``S_t = alpha_t S_{t-1} (I - beta_t k_t k_tᵀ) + beta_t v_t k_tᵀ``,
    ``o_t = S_t q_t``, in float64 with the state (d_v x d_k) written out."""
    _, _, reference = _cell()
    gen = torch.Generator().manual_seed(5)
    seq, heads, dk, dv = 7, 2, 3, 4
    q, k = (torch.randn(seq, heads, dk, generator=gen, dtype=torch.float64) for _ in range(2))
    v = torch.randn(seq, heads, dv, generator=gen, dtype=torch.float64)
    alpha = torch.rand(seq, heads, generator=gen, dtype=torch.float64)
    beta = 2 * torch.rand(seq, heads, generator=gen, dtype=torch.float64)
    s = torch.zeros(heads, dv, dk, dtype=torch.float64)
    want = []
    eye = torch.eye(dk, dtype=torch.float64)
    for t in range(seq):
        kk = k[t][:, :, None] * k[t][:, None, :]
        s = (alpha[t][:, None, None] * s @ (eye - beta[t][:, None, None] * kk)
             + beta[t][:, None, None] * v[t][:, :, None] * k[t][:, None, :])
        want.append((s @ q[t][:, :, None])[..., 0])
    got = reference.recurrence(q, k, v, alpha, beta)
    torch.testing.assert_close(got, torch.stack(want), rtol=1e-12, atol=1e-12)


def test_both_kinds_of_layer_match_the_recurrent_reference():
    cfg, program, reference = _cell()
    batch, seq = 2, 8
    layers, (cos, sin), (x,) = program.make_inputs(cfg, batch, seq, 2**31 + 11, 1,
                                                   torch.device("cpu"))
    assert ["gq" in w for w in layers] == [False, True]
    tracing.reset()
    # the card's plan, run by the plain kernels
    sf = stitch(program.build(cfg, batch, seq), options=StitchOptions(device_spec=H100),
                device="cpu")
    y = x
    for w in layers:
        y = sf(y, *w.values(), cos, sin)
    want = reference.forward(cfg, program.shape(cfg), seq, layers, x, cos, sin)
    assert float((y - want).abs().max() / (want - x).abs().max()) < STACK_TOL
    assert sf.num_fallbacks == 0 and sf.num_compiles == 2
    snap = tracing.snapshot()
    for op in ("slice_scatter", "select_scatter", "copy", "select_copy", "convolution",
               "cumsum", "log1p"):
        assert snap.counters[f"lower.{op}"] >= 1, op
    compiles = [s for s in snap.spans if s.name == "compile"]
    assert [s.attrs["arguments"] for s in compiles] == [1 + len(program.LINEAR_WEIGHTS) + 2,
                                                        1 + len(program.FULL_WEIGHTS) + 2]
    linear, full = (p.compiled for p in sf._plans.values())
    # the chunk loop's body is a plan of its own, named with the layer's
    assert linear.stats.loop_calls >= 1 and linear.stats.sub_kernels >= 1
    assert len(linear.launched_kernels) == len(linear.kernels) + linear.stats.sub_kernels
    for s, plan in zip(compiles, (linear, full)):
        assert s.attrs["kernels"] == [k.fn.symbol for k in plan.launched_kernels]
        assert all(re.fullmatch(r"stitch_[0-9a-f]{16}_\w+", k) for k in s.attrs["kernels"])
    assert full.launched_kernels == full.kernels


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
    cfg, program, _ = _cell()
    batch, seq = 1, 64
    layers, (cos, sin), (x,) = program.make_inputs(cfg, batch, seq, 9, 1, card)
    fn = program.build(cfg, batch, seq)
    sf = stitch(fn)
    for w in layers:
        got = sf(x, *w.values(), cos, sin)
        want = fn(x, *w.values(), cos, sin)
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
        assert sf.num_fallbacks == 0
    assert sf.num_compiles == 2
    # the linear plan replays its chunk loop inside its CUDA graph; at this
    # size the full layer is one kernel, which runs eager by the replay
    # rule (at the cell's size both replay: the benchmark's test)
    linear, full = (p.compiled.executable for p in sf._plans.values())
    assert linear.replay_mode == "graph" and full.replay_mode == "eager"
