"""Shard-aware compilation in the port, held against the reference in one
process: the collective IR ops, layout propagation, the sharded compile's
options, stats and plans, the cache salts, the schedule break, and the
verifier's PLAN007/PLAN008.

Every module is built with the reference's ``GraphBuilder`` and carried
across with ``module_from_reference`` (ids and names kept), so both
packages see the same instructions; the port compiles for the CPU.  The
reference's own cases are ``tests/test_sharded_compile.py`` and
``tests/test_verify.py``.
"""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import repro.core.ir as rir
from repro.core.compiler import StitchOptions as RefOptions
from repro.core.compiler import compile_module as ref_compile
from repro.core.pipeline import _measure_salt as ref_measure_salt
from repro.core.shard import propagate_layouts as ref_propagate
from repro.core.verify import verify_shard_attrs as ref_verify_shard
from repro_torch import lint
from repro_torch.core import (
    FusedComputation,
    StitchOptions,
    compile_module,
    fusion_signature,
    module_from_reference,
)
from repro_torch.core import ir as tir
from repro_torch.core.codegen import emit_fusion
from repro_torch.core.pipeline import _measure_salt
from repro_torch.core.shard import (
    MeshShape,
    derive_layouts,
    layout_to_placements,
    mesh_axes_of,
    propagate_layouts,
    spec_to_layout,
)
from repro_torch.core.verify import RULES, verify_shard_attrs

F32 = np.float32
MESH_AXES = (("model", 8),)


# ------------------------------------------------------ collective IR ops
@pytest.mark.parametrize("ir", [rir, tir], ids=["reference", "port"])
def test_collective_shape_inference(ir):
    assert ir.infer_shape("all_reduce", [(4, 8)], {"axes": ("model",)}) == (4, 8)
    assert ir.infer_shape(
        "all_gather", [(4, 8)], {"axes": ("model",), "dim": 1, "group_size": 8}
    ) == (4, 64)
    assert ir.infer_shape(
        "reduce_scatter", [(4, 64)], {"axes": ("model",), "dim": 1, "group_size": 8}
    ) == (4, 8)
    with pytest.raises(ValueError, match="divisible"):
        ir.infer_shape("reduce_scatter", [(4, 9)], {"axes": ("model",), "dim": 1, "group_size": 8})


def test_is_collective_flag():
    b = tir.GraphBuilder("m")
    x = b.parameter("x", (4, 8))
    r = b.all_reduce(x, "model")
    g = b.all_gather(x, ("pod", "data"), dim=0, group_size=4)
    s = b.reduce_scatter(x, "model", dim=1, group_size=8)
    assert r.instr.is_collective and not x.instr.is_collective
    assert not r.instr.is_library_call
    assert r.instr.attrs == {"axes": ("model",)}
    assert g.instr.attrs == {"axes": ("pod", "data"), "dim": 0, "group_size": 4}
    assert g.shape == (16, 8) and s.shape == (4, 1)


# --------------------------------------------------- layout propagation
def _tp_module():
    """Row-parallel dot: x replicated, w k-sharded -> partial -> all_reduce."""
    b = rir.GraphBuilder("tp")
    x = b.parameter("x", (8, 4))
    w = b.parameter("w", (4, 16))
    r = b.all_reduce(b.dot(x, w), "model")
    b.unary("tanh", r)
    return b.module


def _mlp_module():
    """Megatron MLP shard: column-parallel w1, gelu-ish tanh, row-parallel
    w2, all_reduce, then a residual add and a row reduce."""
    b = rir.GraphBuilder("mlp")
    x = b.parameter("x", (8, 16))
    w1 = b.parameter("w1", (16, 8))
    w2 = b.parameter("w2", (8, 16))
    h = b.unary("tanh", b.dot(x, w1))
    y = b.all_reduce(b.dot(h * h, w2), "model")
    b.reduce(b.binary("add", y, x), (1,), "sum")
    return b.module


def _gather_scatter_module():
    """all_gather then reduce_scatter on dim 0, elementwise between."""
    b = rir.GraphBuilder("gs")
    x = b.parameter("x", (8, 4))
    g = b.all_gather(x, "model", dim=0, group_size=8)
    b.reduce_scatter(b.unary("exp", g), "model", dim=0, group_size=8)
    return b.module


def _transpose_broadcast_module():
    """Layouts through transpose, broadcast, reduce, concat and reshape."""
    b = rir.GraphBuilder("tb")
    x = b.parameter("x", (4, 8))
    v = b.parameter("v", (8,))
    t = b.transpose(x, (1, 0))
    bc = b.broadcast(v, (8, 4), (0,))
    s = b.binary("mul", t, bc)
    b.reduce(s, (1,), "max")
    b.concat([s, s], 1)
    b.reshape(s, (32,))
    return b.module


CASES = {
    "tp": (_tp_module, {"x": (None, ("model",)), "w": (("model",), None)}),
    "mlp": (_mlp_module, {"w1": (None, ("model",)), "w2": (("model",), None)}),
    "gather_scatter": (_gather_scatter_module, {"x": (("model",), None)}),
    "transpose_broadcast": (_transpose_broadcast_module, {"x": (None, ("model",)),
                                                          "v": (("model",),)}),
}


def _stamps(module):
    return {i.name: (i.attrs.get("shard"), i.attrs.get("partial")) for i in module.instructions}


@pytest.mark.parametrize("case", list(CASES))
def test_propagate_layouts_partial_tracking(case):
    build, layouts = CASES[case]
    ref = build()
    port = module_from_reference(ref)
    want = ref_propagate(ref, MESH_AXES, layouts)
    got = propagate_layouts(port, MESH_AXES, layouts)
    assert got == want
    assert _stamps(port) == _stamps(ref)
    if case == "tp":
        by = {i.opcode: i for i in port.instructions}
        assert by["dot"].attrs["partial"] == ("model",)
        assert "partial" not in by["all_reduce"].attrs
        assert "partial" not in by["elementwise"].attrs
        assert got["collective_ops"] == 1
    # a second propagation clears stale stamps: the same attrs again
    propagate_layouts(port, MESH_AXES, layouts)
    assert _stamps(port) == _stamps(ref)


def test_propagate_layouts_conflict_raises():
    b = rir.GraphBuilder("c")
    b.binary("add", b.parameter("x", (8, 8)), b.parameter("y", (8, 8)))
    layouts = {"x": (("model",), None), "y": (("data",), None)}
    axes = MESH_AXES + (("data", 2),)
    with pytest.raises(ValueError, match="conflict") as want:
        ref_propagate(b.module, axes, layouts)
    with pytest.raises(ValueError, match="conflict") as got:
        propagate_layouts(module_from_reference(b.module), axes, layouts)
    assert str(got.value) == str(want.value)


def test_propagate_layouts_validates_mesh():
    b = rir.GraphBuilder("v")
    b.all_reduce(b.parameter("x", (8, 8)), "nonexistent")
    with pytest.raises(ValueError, match="mesh has axes"):
        propagate_layouts(module_from_reference(b.module), MESH_AXES, {})
    b2 = rir.GraphBuilder("v2")
    b2.all_gather(b2.parameter("x", (8, 8)), "model", dim=1, group_size=4)
    with pytest.raises(ValueError, match="group_size") as want:
        ref_propagate(b2.module, MESH_AXES, {})
    with pytest.raises(ValueError, match="group_size") as got:
        propagate_layouts(module_from_reference(b2.module), MESH_AXES, {})
    assert str(got.value) == str(want.value)


# ------------------------------------------------- meshes and placements
def test_mesh_axes_and_placements():
    from torch.distributed.tensor import Replicate, Shard

    mesh = MeshShape(("pod", "data", "model"), (2, 16, 16))
    assert mesh_axes_of(mesh) == (("pod", 2), ("data", 16), ("model", 16))
    fake = SimpleNamespace(shape={"data": 4, "model": 2}, axis_names=("data", "model"))
    assert mesh_axes_of(fake) == (("data", 4), ("model", 2))
    lay = spec_to_layout((("pod", "data"), None, "model"), 3)
    assert lay == (("pod", "data"), None, ("model",))
    assert layout_to_placements(lay, mesh) == [Shard(0), Shard(0), Shard(2)]
    assert layout_to_placements(spec_to_layout((("pod", "data"),), 1), mesh) == \
        [Shard(0), Shard(0), Replicate()]
    assert layout_to_placements(None, mesh) == [Replicate()] * 3
    with pytest.raises(ValueError, match="mesh order"):
        layout_to_placements(spec_to_layout((("data", "pod"),), 1), mesh)
    with pytest.raises(ValueError, match="MeshShape"):
        MeshShape(("data",), (2, 2))


# ------------------------------------------------- the sharded compile
def test_sharded_options_validation():
    with pytest.raises(ValueError, match="mesh_axes"):
        StitchOptions(mesh_axes=(("model", 0),)).validate()
    with pytest.raises(ValueError, match="mesh_axes"):
        StitchOptions(mesh_axes=((1, 8),)).validate()
    opts = StitchOptions(mesh_axes=(("model", 4),))
    mesh = MeshShape(("model",), (8,))
    with pytest.raises(ValueError, match="mesh_axes"):
        compile_module(module_from_reference(_tp_module()), opts, device="cpu", mesh=mesh)
    with pytest.raises(ValueError, match="mesh="):
        compile_module(module_from_reference(_tp_module()), device="cpu",
                       param_layouts={"x": (None, ("model",))})


def _plan(compiled):
    ex = compiled.executable
    return ([(f.name, [m.name for m in f.members]) for f in ex.plan.fusions],
            [s.name for s in ex.plan.standalone])


@pytest.mark.parametrize("case", list(CASES))
def test_collective_is_a_schedule_break(case):
    build, layouts = CASES[case]
    ref_module = build()
    port_module = module_from_reference(ref_module)
    ref = ref_compile(ref_module, RefOptions(mesh_axes=MESH_AXES), param_layouts=layouts)
    port = compile_module(port_module, StitchOptions(mesh_axes=MESH_AXES), device="cpu",
                          param_layouts=layouts)
    assert _plan(port) == _plan(ref)
    plan = port.executable.plan
    n = sum(1 for i in port_module.instructions if i.is_collective)
    assert plan.num_collectives == n == sum(1 for s in plan.standalone if s.is_collective)
    assert all(not any(m.is_collective for m in f.members) for f in plan.fusions)
    for field in ("collective_calls", "collective_breaks_spanned", "sharded_instrs",
                  "stitched_kernels", "standalone_kernels", "library_calls"):
        assert getattr(port.stats, field) == getattr(ref.stats, field), field
    assert port.stats.collective_time_s == pytest.approx(ref.stats.collective_time_s, rel=1e-12)
    assert port.stats.collective_calls == n and (port.stats.collective_time_s > 0) == (n > 0)
    assert _stamps(port_module) == _stamps(ref_module)


def test_no_mesh_compile_changes_no_attr():
    ref_module = _mlp_module()
    port_module = module_from_reference(ref_module)
    before = {i.name: dict(i.attrs) for i in port_module.instructions}
    cm = compile_module(port_module, StitchOptions(), device="cpu")
    assert {i.name: dict(i.attrs) for i in port_module.instructions
            if i.opcode != "call"} == before
    assert cm.stats.sharded_instrs == 0 and "sharding" in cm.stats.pass_times
    assert cm.stats.replay_mode == "eager"


# ------------------------------------------------- cache never aliases
def test_fusion_signature_salted_by_shard_layout():
    def col_parallel():
        b = tir.GraphBuilder("cp")
        x = b.parameter("x", (8, 4))
        w = b.parameter("w", (4, 16))     # the per-shard slice of (4, 128)
        b.unary("tanh", b.dot(x, w))
        return b.module

    m1, m2 = col_parallel(), col_parallel()
    propagate_layouts(m2, MESH_AXES, {"w": (None, ("model",))})
    tanh1 = next(i for i in m1.instructions if i.opcode == "elementwise")
    tanh2 = next(i for i in m2.instructions if i.opcode == "elementwise")
    assert tanh2.attrs["shard"] == (None, ("model",))
    assert "shard" not in tanh1.attrs
    assert fusion_signature(FusedComputation(members=[tanh1])) != \
        fusion_signature(FusedComputation(members=[tanh2]))


def test_measure_salt_covers_mesh():
    plain, sharded = StitchOptions(), StitchOptions(mesh_axes=MESH_AXES)
    assert _measure_salt(plain, "cpu") != _measure_salt(sharded, "cpu")
    # the mesh part of the salt is the reference's, byte for byte
    ref_tail = ref_measure_salt(RefOptions(mesh_axes=MESH_AXES))[len(ref_measure_salt(RefOptions())):]
    assert _measure_salt(sharded, "cpu") == _measure_salt(plain, "cpu") + ref_tail
    assert ref_tail == "mmodel8:"


def test_codegen_refuses_collective_members():
    b = tir.GraphBuilder("cg")
    r = b.all_reduce(b.parameter("x", (8,)), "model")
    f = FusedComputation(members=[r.instr])
    sol = SimpleNamespace(assignment={}, blocks=1)
    with pytest.raises(ValueError, match="collective"):
        emit_fusion(f, sol, plan=None)


# ------------------------------------------------------ PLAN007 / PLAN008
_MESH = (("model", 4),)


def _sharded_reduce_module():
    b = rir.GraphBuilder("shard")
    x = b.parameter("x", (4, 8), F32)
    r = b.reduce(b.square(x), (1,), "sum")  # contracts the sharded dim
    b.tanh(r)
    return b.module


def _conflict_module():
    b = rir.GraphBuilder("conflict")
    b.binary("add", b.parameter("x", (8, 8), F32), b.parameter("y", (8, 8), F32))
    return b.module


def _stale(module, layouts, propagate):
    propagate(module, _MESH, layouts)
    sq = next(i for i in module.instructions if i.opcode == "elementwise")
    sq.attrs["shard"] = (("model",), None)


def _partial_stamp(module, layouts, propagate):
    propagate(module, _MESH, layouts)
    next(i for i in module.instructions if i.opcode == "reduce").attrs.pop("partial")


MUTATIONS = {
    # rule: (module, layouts, mutation, rules expected, rules refused)
    "stale_stamp": (_sharded_reduce_module, {"x": (None, ("model",))}, _stale,
                    {"PLAN007"}, set()),
    "layout_conflict": (_conflict_module,
                        {"x": (("model",), None), "y": (None, ("model",))}, None,
                        {"PLAN007"}, set()),
    "partial_stamp_dropped": (_sharded_reduce_module, {"x": (None, ("model",))},
                              _partial_stamp, {"PLAN007"}, set()),
    "partial_sum_at_root": (_sharded_reduce_module, {"x": (None, ("model",))},
                            lambda m, lay, prop: prop(m, _MESH, lay), {"PLAN008"}, {"PLAN007"}),
}


def _rules(diags):
    return sorted(d.rule for d in diags)


@pytest.mark.parametrize("name", list(MUTATIONS))
def test_shard_rules_match_the_reference(name):
    build, layouts, mutate, want_rules, refused = MUTATIONS[name]
    ref = build()
    port = module_from_reference(ref)
    if mutate is not None:
        mutate(ref, layouts, ref_propagate)
        mutate(port, layouts, propagate_layouts)
    want = ref_verify_shard(ref, _MESH, layouts)
    got = verify_shard_attrs(port, _MESH, layouts)
    assert _rules(got) == _rules(want)
    assert [(d.rule, d.subject, d.message) for d in got] == \
        [(d.rule, d.subject, d.message) for d in want]
    assert want_rules <= set(_rules(got)) and not refused & set(_rules(got))
    assert all(d.rule in RULES for d in got)


def test_honest_stamps_are_clean():
    ref = _tp_module()
    port = module_from_reference(ref)
    layouts = CASES["tp"][1]
    propagate_layouts(port, MESH_AXES, layouts)
    assert verify_shard_attrs(port, MESH_AXES, layouts) == []
    layouts_, partial, counters = derive_layouts(port, MESH_AXES, layouts)
    assert counters["collective_ops"] == 1 and partial


def test_pipeline_runs_the_shard_lint():
    """A strict sharded compile verifies the stamps at every boundary, and
    an open partial sum at a root fails it with PLAN008."""
    layouts = CASES["mlp"][1]
    cm = compile_module(module_from_reference(_mlp_module()),
                        StitchOptions(mesh_axes=MESH_AXES, verify="strict"), device="cpu",
                        param_layouts=layouts)
    assert cm.stats.verify_boundaries == 8 and cm.stats.sharded_instrs > 0
    from repro_torch.core import VerificationError

    with pytest.raises(VerificationError, match="PLAN008"):
        compile_module(module_from_reference(_sharded_reduce_module()),
                       StitchOptions(mesh_axes=_MESH), device="cpu",
                       param_layouts={"x": (None, ("model",))})


def test_lint_lists_the_shard_rules(capsys):
    assert lint.main(["--rules"]) == 0
    out = capsys.readouterr().out
    for rule in ("PLAN007", "PLAN008"):
        assert f"{rule}  {RULES[rule]}" in out
    assert len(RULES) == 22


def test_options_replace_keeps_mesh_axes():
    opts = dataclasses.replace(StitchOptions(), mesh_axes=MESH_AXES)
    assert opts.mesh_axes == MESH_AXES and StitchOptions().mesh_axes is None
    assert torch.device("cpu").type in _measure_salt(opts, "cpu")
