"""The port commits the reference's plan on every paper graph.

Ten graphs x both planners x stitching on and off: the reference module is
carried across with ``module_from_reference`` (ids and names kept) and both
packages compile it under the same options — the reference in interpret
mode, the port for the CPU.  Fusions, schedules, memory plans, stitch
phases, kernel sharing and the plan statistics must be identical;
``planner_predicted_s`` agrees to 1e-12 relative.  Signature hashes differ
by design (the options salt names the device instead of ``interpret``).
"""
import pytest

from graphs import ALL_GRAPHS
from repro.core import StitchOptions as RefOptions
from repro.core import compile_module as ref_compile
from repro_torch.core import StitchOptions, compile_module
from repro_torch.core.interop import module_from_reference

STATS = (
    "stitched_kernels", "standalone_kernels", "library_calls",
    "xla_baseline_kernels", "unique_kernels", "greedy_kernels",
    "planner_packs", "planner_stitches", "stitch_lowered_kernels",
    "stitch_phases_total", "stitch_interface_bytes",
    "kernel_cache_hits", "planner_kernels", "unfused_kernels",
)


def _sched(s):
    return (s.kind, s.split_dim, s.sword, s.sched_type)


def _assignment(sol):
    return {i: _sched(s) for i, s in sol.assignment.items()}, sol.blocks


def _memory(plan):
    entries = {i: (e.action, e.slot, e.nbytes, tuple(e.shape), e.required)
               for i, e in plan.entries.items()}
    slots = [(tuple(s), str(d)) for s, d in plan.slots]
    return entries, slots, plan.total_bytes, plan.shared_bytes, list(plan.shrunk)


def _kernel_view(k):
    if k.stitched is None:
        return ("single", _assignment(k.solution), _memory(k.plan))
    phases = [
        ([m.name for m in p.members], [r.name for r in p.roots], _assignment(p.solution))
        for p in k.stitched.phases
    ]
    ifaces = {
        i: (b.slot, tuple(b.shape), b.nbytes, b.produced_phase, b.last_consumer_phase)
        for i, b in k.plan.interfaces.items()
    }
    return (
        "stitched", phases, [i.name for i in k.stitched.interfaces], ifaces,
        [_memory(p) for p in k.plan.phase_plans], k.plan.interface_bytes, k.plan.io_bytes,
    )


def _plan_view(compiled):
    ex = compiled.executable
    fusions = [(f.name, [m.name for m in f.members]) for f in ex.plan.fusions]
    kernels = {name: _kernel_view(k) for name, k in ex.kernels.items()}
    groups = {}
    for name, k in ex.kernels.items():
        groups.setdefault(id(k.fn), []).append(name)
    sharing = sorted(sorted(g) for g in groups.values())
    standalone = [s.name for s in ex.plan.standalone]
    return fusions, kernels, sharing, standalone


@pytest.mark.parametrize("stitching", [True, False], ids=["stitch", "nostitch"])
@pytest.mark.parametrize("planner", ["cost", "greedy"])
@pytest.mark.parametrize("name", list(ALL_GRAPHS))
def test_port_commits_the_reference_plan(name, planner, stitching):
    ref_module = ALL_GRAPHS[name]()
    port_module = module_from_reference(ref_module)
    ref = ref_compile(ref_module, RefOptions(planner=planner, enable_stitching=stitching))
    port = compile_module(
        port_module, StitchOptions(planner=planner, enable_stitching=stitching), device="cpu"
    )
    r_fusions, r_kernels, r_sharing, r_standalone = _plan_view(ref)
    p_fusions, p_kernels, p_sharing, p_standalone = _plan_view(port)
    assert p_fusions == r_fusions
    assert p_standalone == r_standalone
    assert p_sharing == r_sharing
    assert p_kernels.keys() == r_kernels.keys()
    for k in r_kernels:
        assert p_kernels[k] == r_kernels[k], k
    for field in STATS:
        assert getattr(port.stats, field) == getattr(ref.stats, field), field
    assert port.stats.planner_predicted_s == pytest.approx(ref.stats.planner_predicted_s, rel=1e-12)
    assert port.stats.planner_mode == ref.stats.planner_mode
