"""Thread order of the generated pure maps.

A pure map (a phase that keeps no slot) strides its elements over the whole
grid.  Where a member's chunk is one contiguous span of its output, the loop
is the parent's: ``t`` runs over the plan blocks' chunks one after another,
``b = t / n`` and ``i = t % n``, which is the output's own order.  Where the
chunk is not (a dimension chunked and a later one not whole: the causal
mask broadcast on ``[B, H, S, 1]``, the score scaling on ``[B, H, S, 2]``),
that order would step a warp's stores one chunk's stride apart, so the loop
walks the output in its row-major order instead (``_Phase._ordered_head``):
``t`` unravels over the output, each dimension's chunk index and index in
the chunk are recovered from it, and ``b`` is formed from the chunk indices
as ``schedule.block_index`` numbers plan blocks.

Each loop here is read back from the emitted text: every ``t`` is
substituted into its C index statements (non-negative integers, so C's
``/`` and ``%`` are Python's ``//`` and ``%``), and the offset each store
writes must be ``t`` itself, or, for a loop that keeps the parent's form,
each element once.  ``codegen.map_loops`` and ``codegen.map_loops_reordered``
count the loops on the tracer.  Plans and text only, except the ``card``
test: on the card,
``PYTHONPATH=src python -m pytest -q --noconftest -m card tests/test_torch_map_order.py``.
"""
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import stitch, tracing
from repro_torch.core import StitchOptions, codegen, compile_module, trace
from repro_torch.core.fusion import FusedComputation, constant_like
from repro_torch.core.latency import H100
from repro_torch.core.memory import plan_memory, plan_stitched_memory
from repro_torch.core.pipeline import default_vmem_limit
from repro_torch.core.schedule import (
    COLUMN,
    ROW,
    PhaseSolution,
    Sched,
    StitchedSolution,
    block_index,
    blocks_of,
    chunk_shape,
    resolve_schedules,
)

B, H, S = 2, 3, 64
SCORES = (B, H, S, S)
#: the causal attention of ``stitchbench/programs/decoder_layer.py`` at
#: granite-moe-3b-a800m's widths over 1 x 1024 tokens, which the card test
#: holds against the plain function
CARD_TOKENS = (1, 1024)
TOL = 2e-5


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card")
    return torch.device("cuda", 0)


def _mask(b, x):
    m = b.binary("ge", b.iota((S, S), 0, np.int32), b.iota((S, S), 1, np.int32))
    return b.broadcast(m, SCORES, (2, 3))


def _scale(b, x):
    return x * 0.125


def _mask_of(shape):
    def fn(b, x):
        n = shape[-1]
        m = b.binary("ge", b.iota((n, n), 0, np.int32), b.iota((n, n), 1, np.int32))
        return b.broadcast(m, shape, (2, 3))
    return fn


def _counted(fn):
    """What ``fn()`` returns, and how far it moved the two loop counters."""
    before = tracing.snapshot().counters
    out = fn()
    after = tracing.snapshot().counters
    return out, tuple(after.get(k, 0) - before.get(k, 0)
                      for k in ("codegen.map_loops", "codegen.map_loops_reordered"))


def _emit(fn, spec, root: Sched):
    """``fn`` over ``spec`` as one ``emit_fusion`` kernel, every member in
    it, its root under ``root``."""
    module = trace(fn, spec)
    members = [i for i in module.instructions if i.opcode != "parameter"]
    fusion = FusedComputation(members, name="probe")
    roots = fusion.roots
    sol = resolve_schedules(members, roots, {r.id: root for r in roots}, 1 << 40, spec=H100)
    plan = plan_memory(members, roots, sol, default_vmem_limit(H100), H100)
    return codegen.emit_fusion(fusion, sol, plan)


def _chain(b, x):
    for _ in range(4):
        x = x * 1.5 + 0.25
    return x


def _stitched(first: Sched, second: Sched):
    """The map chain over the scores cut into two phases, the first under
    ``first``, the second under ``second``: one stitched kernel through a
    staged interface."""
    module = trace(_chain, ("x", SCORES, np.float32), name="chain")
    members = [i for i in module.instructions if i.opcode != "parameter"]
    ops = [m for m in members if not constant_like(m)]
    cut = {m.id: 2 * k // len(ops) for k, m in enumerate(ops)}
    phase_of = {}
    for m in reversed(members):
        phase_of[m.id] = cut.get(m.id, min((phase_of[u.id] for u in m.users if u.id in phase_of),
                                           default=0))
    phases = []
    for k, sched in enumerate((first, second)):
        ms = [m for m in members if phase_of[m.id] == k]
        ids = {m.id for m in ms}
        roots = [m for m in ms if not m.users or any(u.id not in ids for u in m.users)]
        sol = resolve_schedules(ms, roots, {r.id: sched for r in roots}, 1 << 40, spec=H100)
        phases.append(PhaseSolution(ms, roots, sol))
    ifaces = [m for m in members if any(phase_of[u.id] > phase_of[m.id] for u in m.users)]
    st = StitchedSolution(phases, ifaces)
    return codegen.emit_stitched_fusion(FusedComputation(members, name="chain"), st,
                                        plan_stitched_memory(st, default_vmem_limit(H100), H100))


def _loops(source):
    """Every grid-strided loop over ``t``: (its count, its body's lines)."""
    lines = source.splitlines()
    out = []
    for k, line in enumerate(lines):
        head = re.match(r"(\s*)for \((?:int|long long) t = .*; t < (\d+); t \+= ", line)
        if not head:
            continue
        end = next(j for j in range(k + 1, len(lines)) if lines[j] == head.group(1) + "}")
        out.append((int(head.group(2)), lines[k + 1:end]))
    return out


_INDEX_NAME = re.compile(r"^(?:g_rem|g\d+|q\d+|o\d+|o_rem|b|i)$")


def _py(expr):
    return expr.replace("static_cast<long long>", "").replace(" / ", " // ")


def _offsets(body, ts):
    """Each store of the loop: (its pointer, the offset it writes at each
    ``t`` of ``ts``), from the loop's integer index statements."""
    env = {"t": ts}
    for line in body:
        for stmt in line.strip().split(";"):
            stmt = stmt.strip()
            decl = re.match(r"^(?:const )?(?:int|long long) (\w+) = (.*)$", stmt)
            if decl and _INDEX_NAME.match(decl.group(1)):
                env[decl.group(1)] = eval(_py(decl.group(2)), {}, env)
            step = re.match(r"^(\w+) /= (\d+)$", stmt)
            if step and _INDEX_NAME.match(step.group(1)):
                env[step.group(1)] = env[step.group(1)] // int(step.group(2))
    out = []
    for line in body:
        store = re.match(r"^\s*((?:out|s)\d+)\[", line)
        if store:
            (idx,) = codegen._indices(line, store.group(1))
            out.append((store.group(1), np.broadcast_to(eval(_py(idx), {}, env), ts.shape)))
    return out


def _ordered(body):
    return any(line.strip().startswith(("int g_rem = t;", "long long g_rem = t;"))
               for line in body)


def _check_loops(source, shapes):
    """Every pure-map loop of ``source`` writes each element of each output
    (``shapes``: its size by pointer) once; a reordered loop writes element
    ``t`` at step ``t``.  Returns the loops' (ordered, count) pairs."""
    seen = []
    for n, body in _loops(source):
        ts = np.arange(n, dtype=np.int64)
        stores = _offsets(body, ts)
        assert stores, body
        for ptr, off in stores:
            assert n == shapes[ptr]
            if _ordered(body):
                assert np.array_equal(off, ts), ptr
            else:
                assert np.array_equal(np.sort(off), ts), ptr
        seen.append((_ordered(body), n))
    return seen


def _tile(shape, sched):
    return list(chunk_shape(shape, sched))


# ---------------------------------------------------------------------------
# the planner's own choice: the causal mask broadcast on [B, H, S, 1]
# ---------------------------------------------------------------------------

def test_mask_broadcast_walks_its_output_in_memory_order():
    cm, moved = _counted(lambda: compile_module(
        trace(_mask, ("x", (1,), np.float32)),
        StitchOptions(device_spec=H100, jit_replay=False), device="cpu"))
    (k,) = cm.kernels
    src = k.fn.source
    assert f"on tile [{B}, {H}, {S}, 1]" in src
    assert _check_loops(src, {"out0": B * H * S * S}) == [(True, B * H * S * S)]
    assert "const int b = g3;" in src and "const int i" not in src
    assert moved == (1, 1)
    assert not k.fn.in_specs
    (got,) = k.fn(device="cpu")
    want = torch.arange(S)[:, None] >= torch.arange(S)[None, :]
    assert torch.equal(got, want.expand(SCORES))


# ---------------------------------------------------------------------------
# hand-set schedules: every chunk that is not one span of its output
# ---------------------------------------------------------------------------

#: (root schedule, its tile over the scores)
NOT_CONTIGUOUS = {
    "minor-1": (Sched("chunked", 2, 1, COLUMN), [B, H, S, 1]),
    "minor-2": (Sched("chunked", 3, S // 2, COLUMN), [B, H, S, 2]),
    "minor-8": (Sched("chunked", 3, S // 8, COLUMN), [B, H, S, 8]),
    "rows-1-1": (Sched("chunked", 1, 1, COLUMN), [B, H, 1, 1]),
    "rows-halved-1": (Sched("chunked", 2, 2, COLUMN), [B, H, S // 2, 1]),
    "heads-1-1-1": (Sched("chunked", 0, 1, COLUMN), [B, 1, 1, 1]),
}


@pytest.mark.parametrize("case", list(NOT_CONTIGUOUS))
def test_scalar_multiply_on_a_chunked_minor_tile_writes_element_t_at_step_t(case):
    sched, tile = NOT_CONTIGUOUS[case]
    assert _tile(SCORES, sched) == tile
    k, moved = _counted(lambda: _emit(_scale, ("x", SCORES, np.float32), sched))
    src = k.fn.source
    assert f"on tile {tile}" in src and "no slot: a pure map over the grid" in src
    assert _check_loops(src, {"out0": B * H * S * S}) == [(True, B * H * S * S)]
    assert moved == (1, 1)
    # the same plan block and element the parent's loop computed there: b
    # is block_index inverted
    x = torch.rand(SCORES)
    (got,) = k.fn(x)
    assert torch.equal(got, x * 0.125)


@pytest.mark.parametrize("case", list(NOT_CONTIGUOUS))
def test_mask_broadcast_on_a_chunked_minor_tile_writes_element_t_at_step_t(case):
    sched, tile = NOT_CONTIGUOUS[case]
    k, moved = _counted(lambda: _emit(_mask, ("x", (1,), np.float32), sched))
    assert _check_loops(k.fn.source, {"out0": B * H * S * S}) == [(True, B * H * S * S)]
    assert moved == (1, 1)


SCHEDULES = [Sched("chunked", s, w, kind)
             for kind in (ROW, COLUMN) for s in range(4) for w in (1, 2)
             if SCORES[s] % w == 0]


@pytest.mark.parametrize("sched", SCHEDULES, ids=repr)
def test_block_of_inverts_block_index(sched):
    for b in range(blocks_of(SCORES, sched)):
        q = block_index(SCORES, sched, b)
        assert codegen._block_of(SCORES, sched, list(q)) == str(b)
    # one span: block 0's elements are the output's first ones
    chunk = chunk_shape(SCORES, sched)
    offs = np.ravel_multi_index(np.indices(chunk).reshape(len(chunk), -1), SCORES)
    assert codegen._contiguous(SCORES, chunk) == np.array_equal(offs, np.arange(offs.size))


# ---------------------------------------------------------------------------
# a stitched kernel with such a phase
# ---------------------------------------------------------------------------

def test_stitched_phase_on_a_chunked_minor_tile_walks_its_output_in_order():
    k, moved = _counted(lambda: _stitched(Sched("chunked", 3, S // 2, COLUMN),
                                          Sched("chunked", 2, 4, ROW)))
    src = k.fn.source
    assert k.fn.emitter == "emit_stitched_fusion" and src.count("sx_grid_sync();") == 1
    assert f"on tile [{B}, {H}, {S}, 2]" in src and f"on tile [1, 1, {S // 4}, {S}]" in src
    n = B * H * S * S
    seen = _check_loops(src, {"out0": n, "s0": n})
    # the first phase's loops walk in memory order, the second's chunk is
    # contiguous and keeps the parent's loop
    assert [o for o, _ in seen] == [True] * (len(seen) - 1) + [False]
    assert moved == (len(seen), len(seen) - 1)
    x = torch.rand(SCORES)
    (got,) = k.fn(x)
    want = x
    for _ in range(4):
        want = want * 1.5 + 0.25
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# a contiguous chunk keeps the parent's text
# ---------------------------------------------------------------------------

#: kernel names (``stitch_`` + the hash of the text) as the parent's
#: emitter gave them (commit ddfcabd)
CONTIGUOUS = {
    "rows-quartered": (lambda: _emit(_scale, ("x", SCORES, np.float32),
                                     Sched("chunked", 2, 4, ROW)), "stitch_ebb0355924d4f82b"),
    "heads": (lambda: _emit(_scale, ("x", SCORES, np.float32),
                            Sched("chunked", 1, 1, ROW)), "stitch_ec743c29cc290892"),
    "elements-column": (lambda: _emit(_scale, ("x", SCORES, np.float32),
                                      Sched("chunked", 0, B, COLUMN)), "stitch_506b0ccb5d61071d"),
    "mask-rows": (lambda: _emit(_mask, ("x", (1,), np.float32),
                                Sched("chunked", 2, 8, ROW)), "stitch_e27fdfc3d0a12cb3"),
    "stitched-rows": (lambda: _stitched(Sched("chunked", 2, 4, ROW), Sched("chunked", 1, 1, ROW)),
                      "stitch_d76612ee60033ef8"),
}


@pytest.mark.parametrize("case", list(CONTIGUOUS))
def test_contiguous_chunk_keeps_the_parents_loop(case):
    build, parent = CONTIGUOUS[case]
    k, moved = _counted(build)
    src = k.fn.source
    seen = _check_loops(src, {"out0": B * H * S * S, "s0": B * H * S * S})
    assert seen and not any(o for o, _ in seen)
    assert "g_rem" not in src
    assert moved == (len(seen), 0)
    assert k.fn.name == parent


# ---------------------------------------------------------------------------
# past 2^31 - 1: the new unravel in 64 bits
# ---------------------------------------------------------------------------

#: (scores shape, elements): past INT_MAX, and under it with the grid's
#: stride past it
WIDE_MASKS = {"past": (2, 8, 16384, 16384), "stride-past": (2, 8, 8200, 8200)}


@pytest.mark.parametrize("case", list(WIDE_MASKS))
def test_wide_mask_broadcast_unravels_in_64_bits(case):
    shape = WIDE_MASKS[case]
    n = int(np.prod(shape))
    assert (n > codegen.INT_MAX) == (case == "past") and 2 * n > codegen.INT_MAX
    k, moved = _counted(lambda: _emit(_mask_of(shape), ("x", (1,), np.float32),
                                      Sched("chunked", 2, 1, COLUMN)))
    src = k.fn.source
    # imported here: its module needs the tests' conftest, the card test not
    from test_torch_index64 import _assert_wide

    _assert_wide(src)
    assert "long long g_rem = t;" in src and "const long long b = g3;" in src
    assert moved == (1, 1)
    ((count, body),) = _loops(src)
    assert count == n
    # every element from the first and last warps, and a sample between
    ts = np.concatenate([np.arange(64), n - 64 + np.arange(64),
                         np.random.default_rng(0).integers(0, n, 4096)]).astype(np.int64)
    ((ptr, off),) = _offsets(body, ts)
    assert ptr == "out0" and np.array_equal(off, ts)


# ---------------------------------------------------------------------------
# on the card: the benchmark's attention at a small shape
# ---------------------------------------------------------------------------

def _attention(device):
    from stitchbench.programs import decoder_layer as dl

    cfg = json.loads(Path("stitchbench/configs/granite-moe-3b-a800m.attn.json").read_text())
    batch, seq = CARD_TOKENS
    fn = dl.build(cfg, batch, seq)
    layers, (cos, sin), (x,) = dl.make_inputs(cfg, batch, seq, 30, 1, device)
    return fn, (x, *layers[0].values(), cos, sin)


@pytest.mark.card
def test_attention_on_the_card_reorders_its_chunked_minor_maps(card):
    """The generated attention equals the plain function on the card.  Its
    own plan launches no pure map on a chunked minor tile since its softmax
    is one kernel (a value computed from indices alone is not held to the
    replicate limit on the GPU): the mask broadcast and the score scaling
    on ``[..., 1]`` and ``[..., 2]`` tiles are built here as the parent's
    plan had them, walk their outputs in memory order and equal their
    plain versions on the card."""
    from repro_torch.core import cuda_build

    torch.backends.cuda.matmul.allow_tf32 = False
    fn, args = _attention(card)
    sf = stitch(fn)
    got = sf(*args)
    torch.testing.assert_close(got, fn(*args), rtol=TOL, atol=TOL)
    maps = {case: (_emit(_scale, ("x", SCORES, np.float32), NOT_CONTIGUOUS[case][0]),
                   _emit(_mask, ("x", (1,), np.float32), NOT_CONTIGUOUS[case][0]))
            for case in ("minor-1", "minor-2")}
    kernels = [k for pair in maps.values() for k in pair]
    lib, _ = cuda_build.load(codegen.assemble_source([k.fn for k in kernels]))
    for k in kernels:
        assert "no slot" in k.fn.source and "g_rem = t;" in k.fn.source
        k.fn.load(lib)
    x = torch.rand(SCORES, device=card)
    want_mask = (torch.arange(S)[:, None] >= torch.arange(S)[None, :]).expand(SCORES)
    for scale, mask in maps.values():
        (y,) = scale.fn(x)
        assert torch.equal(y.cpu(), x.cpu() * 0.125)
        (m,) = mask.fn(device=card)
        assert torch.equal(m.cpu(), want_mask)
