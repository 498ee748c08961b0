"""The port's verifier and lint: every ported rule fires on its mutation.

Each mutation compiles a known-good state with ``verify="off"`` on the CPU,
corrupts one artifact (module, fusion plan, schedule solution, cache entry,
kernel record or execution plan) and asserts the matching family reports
the documented rule id.  The reference's corpus is
``tests/test_verify.py``; PLAN007 and PLAN008 (shard layouts) wait for the
port's sharding.  Then the modes, the environment override, strict compiles
of the ten graphs and the lint CLI.  Last, the port's verifier against the
reference's (``repro.core.verify``): every rule but EXEC004 on the same
mutated input in both packages must report the same rule ids, and the ten
graphs and the loop modules are clean to both.
"""
import numpy as np
import pytest
import torch

from repro_torch import lint
from repro_torch.core import (
    CompilationState,
    FusedComputation,
    GraphBuilder,
    KernelCache,
    StitchOptions,
    VerificationError,
    compile_module,
    default_pipeline,
    trace,
    verify_execution_plan,
    verify_module,
)
from repro_torch.core.codegen import SMEM_LIMIT
from repro_torch.core.perf_library import PerfLibrary
from repro_torch.core.verify import (
    RULES,
    resolve_verify_mode,
    verify_fusion_groups,
    verify_planned_entries,
)
from repro_torch.graphs import ALL_GRAPHS, LOOP_GRAPHS

F32 = np.float32


def _rmsnorm_module():
    def f(b, x, g):
        ms = b.reduce(b.square(x), (1,), "mean")
        inv = b.rsqrt(ms + 1e-6)
        return x * b.broadcast(inv, x.shape, (0,)) * b.broadcast(g, x.shape, (1,))

    return trace(f, ("x", (8, 32), F32), ("g", (32,), F32))


def _stacked_module(n=2):
    def f(b, x, *weights):
        gs, ws = weights[:n], weights[n:]
        for g, w in zip(gs, ws, strict=True):
            ms = b.reduce(b.square(x), (1,), "mean")
            inv = b.rsqrt(ms + 1e-6)
            normed = x * b.broadcast(inv, x.shape, (0,)) * b.broadcast(g, x.shape, (1,))
            x = x + b.tanh(b.dot(normed, w))
        return x

    specs = [("x", (8, 32), F32)]
    specs += [(f"g{i}", (32,), F32) for i in range(n)]
    specs += [(f"W{i}", (32, 32), F32) for i in range(n)]
    return trace(f, *specs)


def _compiled_state(module=None, **kw):
    opts = StitchOptions(max_blocks=kw.pop("max_blocks", 32), verify="off", **kw)
    state = CompilationState(
        module=module if module is not None else _rmsnorm_module(), options=opts,
        library=PerfLibrary(), kernel_cache=KernelCache(), device=torch.device("cpu"),
    )
    default_pipeline().run(state)
    return state


def _by_opcode(module, opcode):
    return next(i for i in module.instructions if i.opcode == opcode)


def _partition(module, members):
    """One fusion of ``members``, everything else standalone."""
    ids = {m.id for m in members}
    standalone = [i for i in module.instructions if i.opcode != "parameter" and i.id not in ids]
    return [FusedComputation(members=list(members), name="bad")], standalone


def _rules(diags):
    return {d.rule for d in diags}


# ------------------------------------------------------------- mutations
def _ir001():
    m = _rmsnorm_module()
    m.instructions.remove(_by_opcode(m, "reduce").operands[0])
    return verify_module(m)


def _ir002():
    m = _rmsnorm_module()
    m.instructions.insert(0, m.instructions.pop())
    return verify_module(m)


def _ir003():
    m = _rmsnorm_module()
    red = _by_opcode(m, "reduce")
    red.operands[0].users.remove(red)
    return verify_module(m)


def _ir004():
    m = _rmsnorm_module()
    m.instructions[-1].id = m.instructions[0].id
    return verify_module(m)


def _ir005():
    m = _rmsnorm_module()
    _by_opcode(m, "reduce").shape = (7,)
    return verify_module(m)


def _ir006():
    m = _rmsnorm_module()
    next(i for i in m.instructions if i.opcode == "elementwise").dtype = np.dtype(np.int32)
    return verify_module(m)


def _ir007():
    m = LOOP_GRAPHS["DecodeLoop"]()
    assert verify_module(m) == []
    _by_opcode(m, "get").shape = (4, 15)
    return verify_module(m)


def _ir008():
    m = _rmsnorm_module()
    m.parameters[1].name = m.parameters[0].name
    return verify_module(m)


def _plan001():
    m = _rmsnorm_module()
    return verify_fusion_groups(*_partition(m, [_by_opcode(m, "elementwise"), m.roots[0]]), m)


def _plan002():
    b = GraphBuilder("span")
    x, w = b.parameter("x", (8, 8), F32), b.parameter("w", (8, 8), F32)
    s = b.square(x)
    b.binary("add", s, b.tanh(b.dot(s, w)))      # an LC layer between s and the root
    m = b.module
    return verify_fusion_groups(*_partition(m, [s.instr, m.roots[0]]), m)


def _plan003():
    b = GraphBuilder("lib")
    x, w = b.parameter("x", (8, 8), F32), b.parameter("w", (8, 8), F32)
    b.tanh(b.dot(b.square(x), w))
    m = b.module
    return verify_fusion_groups(*_partition(m, [_by_opcode(m, "dot")]), m)


def _plan004():
    b = GraphBuilder("const")
    x = b.parameter("x", (8,), F32)
    c = b.constant(np.ones((8,), F32))
    y = x + c
    m = b.module
    return verify_fusion_groups(*_partition(m, [c.instr, y.instr]), m)


def _plan005():
    state = _compiled_state()
    p = next(p for p in state.planned if p.is_representative)
    assignment = (p.entry.stitched.phases[0].solution.assignment if p.entry.stitched
                  else p.entry.solution.assignment)
    assignment.pop(next(iter(assignment)))
    return verify_planned_entries(state)


def _plan006():
    state = _compiled_state()
    assert verify_planned_entries(state) == []
    state.options.vmem_limit = 16          # the plan no longer fits its budget
    diags = verify_planned_entries(state)
    state.options.vmem_limit = 4 * 1024 * 1024
    # and a kernel asking more shared memory than a Hopper block has
    state.planned[0].kernel.fn.shared_bytes = SMEM_LIMIT + 16
    more = verify_planned_entries(state)
    assert [d.rule for d in more] == ["PLAN006"] and "shared memory" in more[0].message
    return diags + more


def _plan009():
    m = _rmsnorm_module()
    red = _by_opcode(m, "reduce")
    covered = [i for i in m.instructions if i.opcode != "parameter" and i.id != red.id]
    gap = verify_fusion_groups([], covered, m)
    dup = verify_fusion_groups([], covered + [red, red], m)
    assert "PLAN009" in _rules(gap) and "PLAN009" in _rules(dup)
    return gap + dup


def _execution_plan():
    state = _compiled_state(_stacked_module())
    ep = state.executable.execution_plan
    assert verify_execution_plan(ep) == []
    return ep


def _exec001():
    ep = _execution_plan()
    bogus = max(s for st in ep.steps for s in st.arg_slots) + 100
    ep.steps[0].arg_slots = [bogus] + list(ep.steps[0].arg_slots)[1:]
    return verify_execution_plan(ep)


def _exec002():
    ep = _execution_plan()
    victim = next(next(iter(st.arg_slots)) for st in reversed(ep.steps[1:]) if st.arg_slots)
    ep.steps[0].release = list(ep.steps[0].release) + [victim]
    return verify_execution_plan(ep)


def _exec003():
    ep = _execution_plan()
    ep.steps[-1].release = list(ep.steps[-1].release) + [ep._root_binds[0][1]]
    return verify_execution_plan(ep)


def _exec004():
    """The CUDA-graph audit: a parameter slot released into the graph's
    pool, a slot still read released into it, and a step writing a
    template slot are each refused."""
    ep = _execution_plan()
    seg = ep._graph
    param = ep._param_binds[0][1]
    seg.pool_released = set(seg.pool_released) | {param}
    diags = verify_execution_plan(ep)
    assert any("protected" in d.message for d in diags if d.rule == "EXEC004")

    ep = _execution_plan()
    seg = ep._graph
    live = next(s for s in seg.out_slots)           # a root: read after the graph
    seg.pool_released = set(seg.pool_released) | {live}
    seg.steps[-1].release.append(live)
    more = verify_execution_plan(ep)
    assert any("still read" in d.message for d in more if d.rule == "EXEC004")
    return diags + more


def _exec005():
    state = _compiled_state()
    p = next(p for p in state.planned if p.raw_signature is not None)
    p.raw_signature = "0" * len(p.raw_signature)
    return verify_planned_entries(state)


MUTATIONS = {
    "IR001": _ir001, "IR002": _ir002, "IR003": _ir003, "IR004": _ir004, "IR005": _ir005,
    "IR006": _ir006, "IR007": _ir007, "IR008": _ir008,
    "PLAN001": _plan001, "PLAN002": _plan002, "PLAN003": _plan003, "PLAN004": _plan004,
    "PLAN005": _plan005, "PLAN006": _plan006, "PLAN009": _plan009,
    "EXEC001": _exec001, "EXEC002": _exec002, "EXEC003": _exec003, "EXEC004": _exec004,
    "EXEC005": _exec005,
}


def test_every_ported_rule_has_a_mutation():
    assert set(MUTATIONS) == set(RULES)
    assert len(RULES) == 20 and "PLAN007" not in RULES and "PLAN008" not in RULES


@pytest.mark.parametrize("rule", sorted(MUTATIONS))
def test_rule_fires_on_its_mutation(rule):
    diags = MUTATIONS[rule]()
    assert rule in _rules(diags)
    assert all(d.rule in RULES for d in diags)


def test_clean_states_have_no_diagnostics():
    assert verify_module(_rmsnorm_module()) == []
    state = _compiled_state(_stacked_module())
    assert verify_planned_entries(state) == []
    assert verify_execution_plan(state.executable.execution_plan) == []


def test_module_verify_raises_verification_error():
    m = _rmsnorm_module()
    _by_opcode(m, "reduce").shape = (7,)
    with pytest.raises(VerificationError) as exc:
        m.verify()
    assert isinstance(exc.value, ValueError)
    assert any(d.rule == "IR005" for d in exc.value.diagnostics)


# ---------------------------------------------------- modes and overhead
def test_verify_off_leaves_no_trace():
    comp = compile_module(_rmsnorm_module(), StitchOptions(max_blocks=32, verify="off"), device="cpu")
    assert "verify" not in comp.stats.pass_times
    assert comp.stats.verify_mode == "off" and comp.stats.verify_boundaries == 0


def test_verify_checkpoint_is_default_single_boundary():
    assert StitchOptions().verify == "checkpoint"
    comp = compile_module(_rmsnorm_module(), StitchOptions(max_blocks=32), device="cpu")
    assert comp.stats.verify_mode == "checkpoint" and comp.stats.verify_boundaries == 1
    assert "verify" in comp.stats.pass_times


def test_verify_strict_checks_every_boundary():
    comp = compile_module(_rmsnorm_module(), StitchOptions(max_blocks=32, verify="strict"),
                          device="cpu")
    assert comp.stats.verify_mode == "strict"
    assert comp.stats.verify_boundaries == len(default_pipeline().passes) == 7
    assert comp.stats.verify_warnings == 0


def test_env_var_overrides_option(monkeypatch):
    monkeypatch.setenv("REPRO_VERIFY", "strict")
    comp = compile_module(_rmsnorm_module(), StitchOptions(max_blocks=32, verify="off"), device="cpu")
    assert comp.stats.verify_mode == "strict" and comp.stats.verify_boundaries == 7


def test_bad_env_value_rejected(monkeypatch):
    monkeypatch.setenv("REPRO_VERIFY", "paranoid")
    with pytest.raises(ValueError, match="REPRO_VERIFY"):
        resolve_verify_mode(StitchOptions())


def test_bad_option_value_rejected():
    with pytest.raises(ValueError, match="verify"):
        StitchOptions(verify="bogus")


def test_pipeline_raises_at_the_pass_that_corrupts():
    from repro_torch.core.pipeline import (
        AutotunePass, CodegenPass, FinalizePass, FusionPass, MemoryPass, PassPipeline,
        SchedulePass, SubModulePass,
    )

    class CorruptingPass(FusionPass):
        def run(self, state):
            super().run(state)
            _by_opcode(state.module, "reduce").shape = (7,)

    pipe = PassPipeline([SubModulePass(), CorruptingPass(), SchedulePass(), MemoryPass(),
                         CodegenPass(), AutotunePass(), FinalizePass()])
    state = CompilationState(
        module=_rmsnorm_module(), options=StitchOptions(max_blocks=32, verify="strict"),
        library=PerfLibrary(), kernel_cache=KernelCache(), device=torch.device("cpu"),
    )
    with pytest.raises(VerificationError) as exc:
        pipe.run(state)
    assert any(d.rule == "IR005" for d in exc.value.diagnostics)
    assert all(d.pass_name == "fusion" for d in exc.value.diagnostics)


@pytest.mark.parametrize("planner", ["cost", "greedy"])
def test_graphs_compile_clean_under_strict(planner):
    for name, build in {**ALL_GRAPHS, **LOOP_GRAPHS}.items():
        comp = compile_module(build(), StitchOptions(max_blocks=64, planner=planner, verify="strict"),
                              device="cpu")
        assert comp.stats.verify_boundaries == 7 and comp.stats.verify_warnings == 0, name


# -------------------------------------------------------------- the lint
def test_lint_exits_zero_on_the_ten_graphs(capsys):
    assert lint.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "clean: zero diagnostics" in out
    assert out.count("boundaries=7") == 2 * len(ALL_GRAPHS)


def test_lint_exits_one_on_a_diagnostic(monkeypatch, capsys):
    def broken(module, opts, device):
        m = _rmsnorm_module()
        _by_opcode(m, "reduce").shape = (7,)
        m.verify()

    monkeypatch.setattr(lint, "compile_module", broken)
    assert lint.main(["--device", "cpu", "--graphs", "LR", "--planner", "cost"]) == 1
    assert "IR005" in capsys.readouterr().err


def test_lint_refuses_unknown_graphs():
    with pytest.raises(SystemExit):
        lint.main(["--device", "cpu", "--graphs", "Nope"])


# ------------------------------------------------ against the reference
# The same input goes through both verifiers: a module built by the
# reference and carried across by ``module_from_reference``, or a state
# compiled by each package from that module, mutated the same way in both.
# The rule ids each reports must be the same set.  EXEC004 has no shared
# mutation: the reference audits ``donate_argnums`` of its jitted segments,
# the port the CUDA graph's pool (``_exec004``).  PLAN007/PLAN008 wait for
# the port's sharding.
import repro.core as R  # noqa: E402
import repro.core.verify as RV  # noqa: E402
from graphs import ALL_GRAPHS as REF_GRAPHS  # noqa: E402
from repro.core.perf_library import PerfLibrary as RefPerfLibrary  # noqa: E402
from repro_torch.core.interop import module_from_reference  # noqa: E402
from repro_torch.core.verify import verify_state  # noqa: E402


def _ref_rmsnorm_module():
    def f(b, x, g):
        ms = b.reduce(b.square(x), (1,), "mean")
        inv = b.rsqrt(ms + 1e-6)
        return x * b.broadcast(inv, x.shape, (0,)) * b.broadcast(g, x.shape, (1,))

    return R.trace(f, ("x", (8, 32), F32), ("g", (32,), F32))


def _ref_stacked_module(n=2):
    def f(b, x, *weights):
        gs, ws = weights[:n], weights[n:]
        for g, w in zip(gs, ws, strict=True):
            ms = b.reduce(b.square(x), (1,), "mean")
            inv = b.rsqrt(ms + 1e-6)
            normed = x * b.broadcast(inv, x.shape, (0,)) * b.broadcast(g, x.shape, (1,))
            x = x + b.tanh(b.dot(normed, w))
        return x

    specs = [("x", (8, 32), F32)]
    specs += [(f"g{i}", (32,), F32) for i in range(n)]
    specs += [(f"W{i}", (32, 32), F32) for i in range(n)]
    return R.trace(f, *specs)


def _ref_span_module():
    b = R.GraphBuilder("span")
    x, w = b.parameter("x", (8, 8), F32), b.parameter("w", (8, 8), F32)
    s = b.square(x)
    b.binary("add", s, b.tanh(b.dot(s, w)))      # an LC layer between s and the root
    return b.module


def _ref_lib_module():
    b = R.GraphBuilder("lib")
    x, w = b.parameter("x", (8, 8), F32), b.parameter("w", (8, 8), F32)
    b.tanh(b.dot(b.square(x), w))
    return b.module


def _ref_const_module():
    b = R.GraphBuilder("const")
    x = b.parameter("x", (8,), F32)
    b.constant(np.ones((8,), F32)) + x
    return b.module


def _ref_decode_loop():
    return LOOP_GRAPHS["DecodeLoop"](builder=R.GraphBuilder)


def _remove(m, instr):
    m.instructions.remove(instr)


def _set(instr, attr, value):
    setattr(instr, attr, value)


#: rule -> (the reference module it starts from, the mutation, in place)
MODULE_PARITY = {
    "IR001": (_ref_rmsnorm_module, lambda m: _remove(m, _by_opcode(m, "reduce").operands[0])),
    "IR002": (_ref_rmsnorm_module, lambda m: m.instructions.insert(0, m.instructions.pop())),
    "IR003": (_ref_rmsnorm_module,
              lambda m: _by_opcode(m, "reduce").operands[0].users.remove(_by_opcode(m, "reduce"))),
    "IR004": (_ref_rmsnorm_module, lambda m: _set(m.instructions[-1], "id", m.instructions[0].id)),
    "IR005": (_ref_rmsnorm_module, lambda m: _set(_by_opcode(m, "reduce"), "shape", (7,))),
    "IR006": (_ref_rmsnorm_module,
              lambda m: _set(_by_opcode(m, "elementwise"), "dtype", np.dtype(np.int32))),
    "IR007": (_ref_decode_loop, lambda m: _set(_by_opcode(m, "get"), "shape", (4, 15))),
    "IR008": (_ref_rmsnorm_module, lambda m: _set(m.parameters[1], "name", m.parameters[0].name)),
}


def _both(build):
    ref = build()
    return ref, module_from_reference(ref)


@pytest.mark.parametrize("rule", sorted(MODULE_PARITY))
def test_module_rules_match_the_reference(rule):
    build, mutate = MODULE_PARITY[rule]
    ref, port = _both(build)
    assert RV.verify_module(ref) == [] and verify_module(port) == []
    mutate(ref)
    mutate(port)
    want = _rules(RV.verify_module(ref))
    assert rule in want
    assert _rules(verify_module(port)) == want


def _groups(members_of):
    """A fusion-group mutation: ``members_of(m)`` gives the members of the
    one fusion, everything else standalone."""
    def run(m, fused_cls, verify):
        members = members_of(m)
        ids = {x.id for x in members}
        standalone = [i for i in m.instructions if i.opcode != "parameter" and i.id not in ids]
        return verify([fused_cls(members=list(members), name="bad")], standalone, m)
    return run


def _coverage_gap(m, fused_cls, verify):
    red = _by_opcode(m, "reduce")
    covered = [i for i in m.instructions if i.opcode != "parameter" and i.id != red.id]
    return verify([], covered, m) + verify([], covered + [red, red], m)


GROUP_PARITY = {
    "PLAN001": (_ref_rmsnorm_module, _groups(lambda m: [_by_opcode(m, "elementwise"), m.roots[0]])),
    "PLAN002": (_ref_span_module, _groups(lambda m: [_by_opcode(m, "elementwise"), m.roots[0]])),
    "PLAN003": (_ref_lib_module, _groups(lambda m: [_by_opcode(m, "dot")])),
    "PLAN004": (_ref_const_module, _groups(lambda m: [_by_opcode(m, "constant"), m.roots[0]])),
    "PLAN009": (_ref_rmsnorm_module, _coverage_gap),
}


@pytest.mark.parametrize("rule", sorted(GROUP_PARITY))
def test_fusion_group_rules_match_the_reference(rule):
    build, run = GROUP_PARITY[rule]
    ref, port = _both(build)
    want = _rules(run(ref, R.FusedComputation, RV.verify_fusion_groups))
    assert rule in want
    assert _rules(run(port, FusedComputation, verify_fusion_groups)) == want


def _ref_state(module, **kw):
    state = R.CompilationState(
        module=module,
        options=R.StitchOptions(max_blocks=kw.pop("max_blocks", 32), verify="off", **kw),
        library=RefPerfLibrary(), kernel_cache=R.KernelCache(),
    )
    R.default_pipeline().run(state)
    return state


def _pop_assignment(state):
    p = next(p for p in state.planned if p.is_representative)
    assignment = (p.entry.stitched.phases[0].solution.assignment if p.entry.stitched
                  else p.entry.solution.assignment)
    assignment.pop(next(iter(assignment)))


def _tiny_budget(state):
    state.options.vmem_limit = 16


def _stale_signature(state):
    p = next(p for p in state.planned if p.raw_signature is not None)
    p.raw_signature = "0" * len(p.raw_signature)


def _read_unwritten(ep):
    bogus = max(s for st in ep.steps for s in st.arg_slots) + 100
    ep.steps[0].arg_slots = [bogus] + list(ep.steps[0].arg_slots)[1:]


def _release_early(ep):
    victim = next(next(iter(st.arg_slots)) for st in reversed(ep.steps[1:]) if st.arg_slots)
    ep.steps[0].release = list(ep.steps[0].release) + [victim]


def _release_root(ep):
    ep.steps[-1].release = list(ep.steps[-1].release) + [ep._root_binds[0][1]]


#: rule -> (the reference module, the mutation of a compiled state, which
#: of the state's checks reads it: its planned entries or its ExecutionPlan)
STATE_PARITY = {
    "PLAN005": (_ref_rmsnorm_module, _pop_assignment, "entries"),
    "PLAN006": (_ref_rmsnorm_module, _tiny_budget, "entries"),
    "EXEC005": (_ref_rmsnorm_module, _stale_signature, "entries"),
    "EXEC001": (_ref_stacked_module, _read_unwritten, "plan"),
    "EXEC002": (_ref_stacked_module, _release_early, "plan"),
    "EXEC003": (_ref_stacked_module, _release_root, "plan"),
}


@pytest.mark.parametrize("rule", sorted(STATE_PARITY))
def test_compiled_state_rules_match_the_reference(rule):
    build, mutate, family = STATE_PARITY[rule]
    ref_module, port_module = _both(build)
    ref, port = _ref_state(ref_module), _compiled_state(port_module)
    if family == "entries":
        assert RV.verify_planned_entries(ref) == [] and verify_planned_entries(port) == []
        mutate(ref)
        mutate(port)
        want, got = RV.verify_planned_entries(ref), verify_planned_entries(port)
    else:
        ref_ep, port_ep = ref.executable.execution_plan, port.executable.execution_plan
        assert RV.verify_execution_plan(ref_ep) == [] and verify_execution_plan(port_ep) == []
        mutate(ref_ep)
        mutate(port_ep)
        want, got = RV.verify_execution_plan(ref_ep), verify_execution_plan(port_ep)
    assert rule in _rules(want)
    assert _rules(got) == _rules(want)


def test_parity_corpus_covers_every_shared_rule():
    shared = set(MODULE_PARITY) | set(GROUP_PARITY) | set(STATE_PARITY)
    assert shared == set(RULES) - {"EXEC004"}
    assert set(RULES) <= set(RV.RULES)


BOTH_GRAPHS = {**REF_GRAPHS, **{n: (lambda b=b: b(builder=R.GraphBuilder))
                                 for n, b in LOOP_GRAPHS.items()}}


@pytest.mark.parametrize("name", list(BOTH_GRAPHS))
def test_graphs_are_clean_in_both_verifiers(name):
    """Each paper graph and loop module, and each compiled state of it, is
    clean to the reference's verifier and to the port's."""
    ref_module, port_module = _both(BOTH_GRAPHS[name])
    assert RV.verify_module(ref_module) == [] and verify_module(port_module) == []
    ref = _ref_state(ref_module, max_blocks=64)
    port = _compiled_state(port_module, max_blocks=64)
    assert RV.verify_state(ref) == []
    assert verify_state(port) == []
