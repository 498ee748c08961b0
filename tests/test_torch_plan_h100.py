"""The planner plans for the device it compiles for.

On the CPU the port plans with ``TPU_V5E`` and 4 MiB, the reference's
constants: every analytic score is the reference's ``LatencyModel`` bit for
bit.  ``device_spec=H100`` (the card's default) plans with the card's 132
SMs, a block's shared memory as the slot budget and recompute charged:
those plans are held here, on the CPU through each kernel's plain version,
against ``reference_execute`` and against the reference's compile of the
same module, at the shapes the repo's tests use and at granite-moe-3b-a800m's
width over 512 tokens.
"""
import math
import os
import sys
from dataclasses import replace

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import repro
from repro.core import latency as ref_latency
from repro_torch import stitch
from repro_torch.core import StitchOptions, compile_module, reference_execute
from repro_torch.core import latency as port_latency
from repro_torch.core.geometry import SMEM_LIMIT, fusion_launch, reduce_part_bytes, stitched_launch
from repro_torch.core.interop import module_from_reference
from repro_torch.core.latency import H100, TPU_V5E, LatencyModel, NotMeasured
from repro_torch.core.measure import MeasuredCostStore, device_fingerprint
from repro_torch.core.pipeline import (
    _measure_salt,
    _options_fingerprint,
    default_vmem_limit,
    resolve_options,
)
from repro_torch.core.perf_library import PerfLibrary
from repro_torch.core.schedule import candidate_schedules, resolve_schedules, Unsatisfiable
from repro_torch.core.signature import KernelCache
from repro_torch.graphs import TORCH_FAMILIES

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "benchmarks"))
from graphs import ALL_GRAPHS, JNP_FAMILIES, random_feeds  # noqa: E402

TOL = 2e-5
GRANITE_TOKENS, GRANITE_D, GRANITE_HEADS, GRANITE_HEAD_DIM = 512, 1536, 24, 64
H100_OPTS = StitchOptions(device_spec=H100)
H100_BUDGET = SMEM_LIMIT - reduce_part_bytes(512)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# TPU_V5E: the reference's scores, bit for bit
# ---------------------------------------------------------------------------


def test_tpu_v5e_fingerprint_is_the_references():
    assert TPU_V5E.fingerprint() == ref_latency.TPU_V5E.fingerprint()
    assert H100.fingerprint() != TPU_V5E.fingerprint()
    assert replace(TPU_V5E, sm_count=2).fingerprint() != TPU_V5E.fingerprint()


def _record(monkeypatch, cls, calls):
    """Wrap ``cls``'s fusion scores to record (kind, member ids, blocks) ->
    the seconds each call returned."""
    fusion_time, stitched_time = cls.fusion_time, cls.stitched_fusion_time

    def ft(self, members, roots, solution, *a, **kw):
        t = fusion_time(self, members, roots, solution, *a, **kw)
        calls[("fusion", tuple(sorted(m.id for m in members)),
               tuple(sorted((k, repr(s)) for k, s in solution.assignment.items())))] = t
        return t

    def st(self, stitched, *a, **kw):
        t = stitched_time(self, stitched, *a, **kw)
        key = tuple(tuple(sorted(m.id for m in p.members)) for p in stitched.phases)
        calls[("stitched", key, tuple(p.solution.blocks for p in stitched.phases))] = t
        return t

    monkeypatch.setattr(cls, "fusion_time", ft)
    monkeypatch.setattr(cls, "stitched_fusion_time", st)


@pytest.mark.parametrize("name", list(ALL_GRAPHS))
def test_tpu_v5e_scores_are_the_references_bit_for_bit(name, monkeypatch):
    """Every candidate the cost planner scores on the CPU (``fusion_time``,
    ``stitched_fusion_time``) costs what the reference's model says, to the
    last bit, and the planner scores the same candidates."""
    ref_calls, port_calls = {}, {}
    _record(monkeypatch, ref_latency.LatencyModel, ref_calls)
    _record(monkeypatch, port_latency.LatencyModel, port_calls)
    ref_module = ALL_GRAPHS[name]()
    repro.compile_module(ref_module, repro.StitchOptions())
    compile_module(module_from_reference(ref_module), StitchOptions(), device="cpu")
    assert ref_calls and port_calls.keys() == ref_calls.keys()
    for key, t in ref_calls.items():
        assert port_calls[key] == t, key


# ---------------------------------------------------------------------------
# which spec and budget a compile plans with
# ---------------------------------------------------------------------------


def _fake_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "NVIDIA H100 80GB HBM3")


def test_the_cpu_plans_with_tpu_v5e_and_4_mib():
    opts = resolve_options(StitchOptions(), "cpu")
    assert opts.device_spec is TPU_V5E and opts.vmem_limit == 4 * 1024 * 1024
    cm = compile_module(module_from_reference(ALL_GRAPHS["NMT"]()), device="cpu")
    assert cm.stats.device == "cpu"
    assert _measure_salt(StitchOptions(), "cpu") == _measure_salt(
        StitchOptions(device_spec=TPU_V5E, vmem_limit=4 << 20), "cpu")


def test_the_card_plans_with_h100_and_a_blocks_shared_memory(monkeypatch):
    _fake_card(monkeypatch)
    opts = resolve_options(StitchOptions(), "cuda")
    assert opts.device_spec is H100
    assert opts.vmem_limit == default_vmem_limit(H100) == H100_BUDGET == 232_320


def test_explicit_values_win_on_either_device(monkeypatch):
    _fake_card(monkeypatch)
    for dev in ("cpu", "cuda"):
        assert resolve_options(StitchOptions(device_spec=TPU_V5E), dev).device_spec is TPU_V5E
        assert resolve_options(StitchOptions(device_spec=TPU_V5E), dev).vmem_limit == 4 << 20
        assert resolve_options(StitchOptions(device_spec=H100), dev).vmem_limit == H100_BUDGET
        assert resolve_options(StitchOptions(vmem_limit=12345), dev).vmem_limit == 12345
    assert resolve_options(StitchOptions(vmem_limit=12345), "cuda").device_spec is H100


def test_the_frontends_store_is_keyed_by_the_resolved_spec(monkeypatch, tmp_path):
    """``stitch``'s measured store takes the fingerprint of the spec its
    compile plans with, as ``compile_module``'s own store does."""
    path = str(tmp_path / "store.json")
    cpu = stitch(lambda x: x * 2.0, options=StitchOptions(tuning_store_path=path), device="cpu")
    assert cpu._get_measured_store().device_fp == device_fingerprint(TPU_V5E, "cpu")
    _fake_card(monkeypatch)
    card = stitch(lambda x: x * 2.0, options=StitchOptions(tuning_store_path=path))
    assert card._get_measured_store().device_fp == device_fingerprint(H100, "cuda")
    pinned = stitch(lambda x: x * 2.0,
                    options=StitchOptions(tuning_store_path=path, device_spec=TPU_V5E))
    assert pinned._get_measured_store().device_fp == device_fingerprint(TPU_V5E, "cuda")


def test_tpu_and_h100_compiles_share_no_cache_entry(tmp_path):
    """Kernel-cache signatures, measured-store keys and PerfLibrary keys
    all carry the spec, so neither spec's entry serves the other."""
    cache = KernelCache()
    store = MeasuredCostStore(str(tmp_path / "m.json"), device_fp="fp")

    def stacked(spec, kernel_cache, measured_store):
        return compile_module(module_from_reference(ALL_GRAPHS["Stacked"]()),
                              StitchOptions(device_spec=spec, jit_replay=False, autotune=True),
                              kernel_cache=kernel_cache, device="cpu",
                              measured_store=measured_store)

    tpu = stacked(TPU_V5E, cache, store)
    tpu_sigs = set(cache._entries)
    alone = stacked(H100, KernelCache(), MeasuredCostStore(None, device_fp="fp"))
    h100 = stacked(H100, cache, store)
    assert tpu.stats.measurements_taken > 0
    assert h100.stats.kernel_cache_hits == alone.stats.kernel_cache_hits
    assert h100.stats.measured_hits == 0
    assert h100.stats.measurements_taken == alone.stats.measurements_taken
    assert not tpu_sigs & (set(cache._entries) - tpu_sigs) and len(cache._entries) > len(tpu_sigs)
    module = module_from_reference(ALL_GRAPHS["Stacked"]())
    assert _measure_salt(StitchOptions(), "cpu") != _measure_salt(H100_OPTS, "cpu")
    assert _options_fingerprint(StitchOptions(), "cpu") != _options_fingerprint(H100_OPTS, "cpu")
    assert _measure_salt(StitchOptions(), "cuda") != _measure_salt(
        StitchOptions(device_spec=TPU_V5E), "cuda")
    instr = next(i for i in module.instructions if i.opcode == "elementwise")
    sched = candidate_schedules(instr.shape)[0]
    tpu_lib, h100_lib = PerfLibrary(), PerfLibrary(model=LatencyModel(H100))
    assert tpu_lib.key(instr, sched, 1) != h100_lib.key(instr, sched, 1)
    assert h100_lib.key(instr, sched, 1).startswith(H100.fingerprint())
    assert tpu_lib.lookup(instr, sched, 1) != h100_lib.lookup(instr, sched, 1)


# ---------------------------------------------------------------------------
# a score never reads a NaN
# ---------------------------------------------------------------------------


def test_a_score_that_reads_nan_raises_and_names_the_field():
    module = module_from_reference(ALL_GRAPHS["BcastHeavy"]())
    spec = replace(H100, vmem_bw=float("nan"))
    with pytest.raises(NotMeasured, match="vmem_bw"):
        compile_module(module, StitchOptions(device_spec=spec), device="cpu")
    model = LatencyModel(H100)
    coll = next((i for i in module.instructions if i.opcode == "elementwise"), None)
    with pytest.raises(NotMeasured, match="ici_latency_s"):
        model.collective_op_time(coll, 4)
    assert not model.prices_collectives and LatencyModel(TPU_V5E).prices_collectives
    for field in ("hbm_bw", "launch_overhead_s", "grid_step_overhead_s", "phase_loop_overhead_s"):
        with pytest.raises(NotMeasured, match=field):
            compile_module(module_from_reference(ALL_GRAPHS["StitchPipe"]()),
                           StitchOptions(device_spec=replace(H100, **{field: math.nan})),
                           device="cpu")


def test_h100_holds_no_nan_a_plan_reads():
    for f in ("vmem_bw", "phase_loop_overhead_s", "launch_overhead_s", "grid_step_overhead_s",
              "hbm_bw", "peak_flops_f32", "vpu_flops"):
        assert not math.isnan(getattr(H100, f)), f
    assert math.isnan(H100.ici_latency_s)
    assert H100.sm_count == 132 and H100.block_curve
    assert all(0.0 < frac <= 1.0 for _, frac in H100.block_curve)


# ---------------------------------------------------------------------------
# what the GPU model charges
# ---------------------------------------------------------------------------


def test_a_grid_that_fills_the_card_scores_cheaper():
    model = LatencyModel(H100)
    assert model.hbm_share(H100.sm_count) > model.hbm_share(16)
    assert model.compute_share(16) == 16 / 132 and model.compute_share(264) == 1.0
    assert model.waves(264, 512) == 1 and model.waves(1000, 512) == 2
    tpu = LatencyModel(TPU_V5E)
    assert tpu.hbm_share(16) == tpu.compute_share(16) == 1.0 and tpu.waves(16, 512) == 16


def _rmsnorm_module(rows, width):
    from repro_torch.core import trace

    def f(b, x, g):
        ms = b.reduce(x * x, (1,)) * (1.0 / width)
        inv = b.rsqrt(ms + 1e-6)
        return x * b.broadcast(inv, x.shape, (0,)) * b.broadcast(g, x.shape, (1,))

    return trace(f, ("x", (rows, width), np.float32), ("g", (width,), np.float32))


def test_a_shrunk_member_is_charged_at_every_read():
    """On a GPU a member the memory plan shrank to INLINE runs once for
    each read of it; under TPU_V5E a shrink stays free."""
    from repro_torch.core.fusion import FusedComputation
    from repro_torch.core.latency import recompute_flops
    from repro_torch.core.memory import plan_memory
    from repro_torch.core.schedule import ROW, Sched
    from repro_torch.core import trace

    def f(b, x):
        e = b.exp(x)
        return e * b.broadcast(b.reduce(e, (1,)), x.shape, (0,))

    module = trace(f, ("x", (64, 1024), np.float32))
    members = [i for i in module.instructions if i.opcode != "parameter"]
    fusion = FusedComputation(members, name="f")
    sol = resolve_schedules(members, fusion.roots,
                            {r.id: Sched("chunked", 0, 64, ROW) for r in fusion.roots}, 1 << 20)
    kept = plan_memory(members, fusion.roots, sol, 1 << 20, H100)
    shrunk = plan_memory(members, fusion.roots, sol, 64, H100)
    assert not kept.shrunk and shrunk.shrunk
    assert recompute_flops(members, kept) == 0.0 and recompute_flops(members, shrunk) > 0.0
    model = LatencyModel(H100)
    assert (model.fusion_time(members, fusion.roots, sol, shrunk)
            > model.fusion_time(members, fusion.roots, sol, None))


@pytest.mark.parametrize("spec", [TPU_V5E, H100], ids=["tpu", "h100"])
@pytest.mark.parametrize("name", list(ALL_GRAPHS))
def test_the_models_grid_is_the_emitted_launch(name, spec):
    """``geometry.fusion_launch`` (what the GPU model charges) is the grid
    and threads ``emit_fusion`` writes into its launcher; for a stitched
    kernel, ``geometry.stitched_launch``'s largest phase grid is the most
    blocks its cooperative launcher asks for, and its threads the kernel's
    launch bounds."""
    import re

    cm = compile_module(module_from_reference(ALL_GRAPHS[name]()),
                        StitchOptions(device_spec=spec, jit_replay=False), device="cpu")
    for k in cm.kernels:
        if k.stitched is None:
            m = re.search(r"<<<(\d+), (\d+), ", k.fn.source)
            launch = fusion_launch(k.fusion.members, k.fusion.roots, k.solution, k.plan)
            grid, threads = launch.grid, launch.threads
        else:
            m = re.search(r"grid = sms \* per_sm < (\d+) \? sms \* per_sm : \1;", k.fn.source)
            launches = stitched_launch(k.stitched, k.plan)
            grid, threads = max(p.grid for p in launches), launches[0].threads
            assert {p.threads for p in launches} == {threads}
            assert f"dim3(grid), dim3({threads}), args, " in k.fn.source
        assert f"__launch_bounds__({threads}) {k.fn.symbol}(" in k.fn.source
        assert int(m.group(1)) == grid, k.fusion.name
        if k.stitched is None:
            assert int(m.group(2)) == threads, k.fusion.name


#: what each planner module may not import, at its top or inside a function:
#: the launch geometry sits below the cost model, so the planner never
#: reaches up into the emitter or the pipeline above it
LAYERS = {name: ("codegen", "pipeline")
          for name in ("latency", "memory", "fusion", "tuning", "schedule", "geometry")}
LAYERS["verify"] = ("codegen",)    # a whole-state checker above the planner


@pytest.mark.parametrize("module", list(LAYERS))
def test_the_planner_imports_downward_only(module):
    import ast

    import repro_torch.core as core

    path = os.path.join(os.path.dirname(core.__file__), f"{module}.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    imported = set()    # every module path part and name an import names
    for node in ast.walk(tree):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            imported.update((getattr(node, "module", None) or "").split("."))
            imported.update(part for a in node.names for part in a.name.split("."))
    assert not imported & set(LAYERS[module]), (module, sorted(imported & set(LAYERS[module])))


# ---------------------------------------------------------------------------
# H100 plans: right, and in shared memory
# ---------------------------------------------------------------------------


def _no_slot_past_the_budget(cm, budget=H100_BUDGET):
    for k in cm.kernels:
        assert k.plan.budget_bytes <= budget, k.fusion.name
        if k.stitched is None:
            assert k.fn.workspace_bytes == 0, k.fn.source.splitlines()[0]
        else:
            # a stitched kernel's workspace holds its staged interfaces alone
            iface = sum(-(-b.nbytes // 16) * 16 for b in k.plan.interfaces.values())
            assert k.fn.workspace_bytes <= iface, k.fn.source.splitlines()[0]
        assert k.fn.shared_bytes <= SMEM_LIMIT


@pytest.mark.parametrize("name", list(ALL_GRAPHS))
def test_h100_plans_of_the_ten_graphs_agree(name):
    """Each graph's H100 plan, run through the plain kernels, agrees with
    ``reference_execute`` and with the reference's compile of the same
    module; no slot leaves shared memory."""
    ref_module = ALL_GRAPHS[name]()
    feeds = random_feeds(ref_module, np.random.RandomState(0))
    cm = compile_module(module_from_reference(ref_module), replace(H100_OPTS, jit_replay=False),
                        device="cpu")
    _no_slot_past_the_budget(cm)
    got = cm({k: torch.as_tensor(v) for k, v in feeds.items()})
    want = reference_execute(cm.executable.module, {k: torch.as_tensor(v) for k, v in feeds.items()},
                             device="cpu")
    ref = repro.compile_module(ref_module, repro.StitchOptions(max_blocks=32))(feeds)
    assert set(got) == set(want) == set(ref)
    mask_tol = 5e-4 if name == "Speech" else TOL   # its near-degenerate softmax columns
    for k in want:
        _close(got[k], want[k].numpy(), mask_tol)
        _close(got[k], np.asarray(ref[k]), mask_tol)


@pytest.mark.parametrize("family", sorted(TORCH_FAMILIES))
def test_h100_plans_of_the_frontends_families_agree(family):
    fam, jfam = TORCH_FAMILIES[family], JNP_FAMILIES[family]
    args = fam["args"](np.random.RandomState(0))
    st = stitch(fam["fn"], options=replace(H100_OPTS, **fam["options"]), device="cpu")
    out = st(*args)
    assert st.num_fallbacks == 0
    want = jax.jit(jfam["fn"])(*args)
    for g, w in zip(jax.tree_util.tree_leaves(out), jax.tree_util.tree_leaves(want), strict=True):
        _close(g.detach().numpy(), np.asarray(w), 2e-4)
    lowered = st.lower()
    feeds = dict(zip(lowered.param_names, jax.tree_util.tree_leaves(args), strict=True))
    ref = reference_execute(lowered.module, feeds, device="cpu")
    _close(jax.tree_util.tree_leaves(out)[0].detach().numpy(),
           ref[lowered._lowered.output_names[0]].numpy(), 2e-4)
    _no_slot_past_the_budget(lowered.compile())


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


def _granite_cases(t=GRANITE_TOKENS, d=GRANITE_D, h=GRANITE_HEADS, hd=GRANITE_HEAD_DIM, ff=512):
    rng = np.random.RandomState(1)
    f4 = np.float32
    return {
        "rmsnorm": (rmsnorm, (rng.randn(t, d).astype(f4), rng.randn(d).astype(f4))),
        "layer_stats": (layer_stats, (rng.randn(t, d).astype(f4),)),
        "gated_mlp": (gated_mlp, (rng.randn(t, d).astype(f4), rng.randn(d, ff).astype(f4),
                                  rng.randn(d, ff).astype(f4))),
        "fig3_attention": (fig3_attention, tuple(rng.randn(1, h, t, hd).astype(f4)
                                                 for _ in range(3))),
    }


def _widest_grid(kernel):
    """The most CUDA blocks any schedule of this fusion's root lowers to."""
    f = kernel.fusion
    best = 1
    for sched in candidate_schedules(f.roots[0].shape, 1 << 16):
        try:
            sol = resolve_schedules(f.members, f.roots, {r.id: sched for r in f.roots
                                                         if tuple(r.shape) == tuple(f.roots[0].shape)},
                                    512 * 1024)
        except (Unsatisfiable, KeyError):
            continue
        best = max(best, fusion_launch(f.members, f.roots, sol, None).grid)
    return best


@pytest.mark.parametrize("name", ["rmsnorm", "layer_stats", "gated_mlp", "fig3_attention"])
def test_granite_width_plans_fill_the_card(name):
    """Under H100, each of the four functions at granite width over 512
    tokens launches at least 132 CUDA blocks a kernel wherever one of its
    schedules can, and keeps every slot within a block's shared memory;
    planned on the CPU only (no kernel runs)."""
    fn, args = _granite_cases()[name]
    cm = stitch(fn, options=H100_OPTS, device="cpu").lower(*args).compile()
    _no_slot_past_the_budget(cm)
    for k in cm.kernels:
        if k.stitched is not None:
            continue
        grid = fusion_launch(k.fusion.members, k.fusion.roots, k.solution, k.plan).grid
        assert grid >= min(H100.sm_count, _widest_grid(k)), (k.fusion.name, grid)
    if name in ("rmsnorm", "layer_stats"):
        (k,) = cm.kernels
        assert k.solution.blocks >= H100.sm_count
    tpu = stitch(fn, options=StitchOptions(max_blocks=32), device="cpu").lower(*args).compile()
    assert [k.solution.blocks for k in tpu.kernels if k.stitched is None][0] <= 32


@pytest.mark.parametrize("name", ["rmsnorm", "layer_stats", "gated_mlp", "fig3_attention"])
def test_h100_plans_of_the_four_functions_agree_at_small_width(name):
    """The same four functions at a narrow width: the H100 plan, through the
    plain kernels, against the plain function, ``reference_execute`` and
    the TPU_V5E plan."""
    fn, args = _granite_cases(t=64, d=96, h=3, hd=16, ff=32)[name]
    want = fn(*[torch.as_tensor(a) for a in args])
    st = stitch(fn, options=H100_OPTS, device="cpu")
    got = st(*args)
    tpu = stitch(fn, options=StitchOptions(max_blocks=32), device="cpu")(*args)
    _close(got.numpy(), want.numpy())
    _close(got.numpy(), tpu.numpy())
    lowered = st.lower()
    ref = reference_execute(lowered.module, dict(zip(lowered.param_names, args, strict=True)),
                            device="cpu")
    _close(got.numpy(), ref[lowered._lowered.output_names[0]].numpy())
    _no_slot_past_the_budget(lowered.compile())


def test_plan006_holds_the_h100_budget():
    """The verifier reads the budget the plan was made within: a GPU plan
    counts its largest stitched phase, not the staged interfaces."""
    from repro_torch.core.memory import plan_stitched_memory

    cm = compile_module(module_from_reference(ALL_GRAPHS["StitchPipe"]()),
                        replace(H100_OPTS, jit_replay=False), device="cpu")
    (k,) = cm.kernels
    assert k.stitched is not None and not k.plan.staged_in_scratch
    assert k.plan.budget_bytes == max(p.budget_bytes for p in k.plan.phase_plans)
    assert k.plan.budget_bytes < k.plan.interface_bytes
    tpu = plan_stitched_memory(k.stitched, 1 << 30)
    assert tpu.budget_bytes == tpu.total_bytes + tpu.io_bytes


def test_a_sharded_compiles_collective_time_is_not_measured_on_h100():
    from repro_torch.core import trace

    def f(b, x):
        return b.all_reduce(x * 2.0, ("model",))

    module = trace(f, ("x", (8, 16), np.float32))
    opts = StitchOptions(mesh_axes=(("model", 4),), jit_replay=False)
    tpu = compile_module(module, opts, device="cpu")
    assert tpu.stats.collective_calls == 1 and tpu.stats.collective_time_s > 0.0
    h100 = compile_module(trace(f, ("x", (8, 16), np.float32)), replace(opts, device_spec=H100),
                          device="cpu")
    assert h100.stats.collective_calls == 1 and h100.stats.collective_time_s is None
