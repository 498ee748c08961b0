"""The FusionStitching compiler facade of the port — ``repro/core/compiler.py``.

``compile_module`` builds the compilation state, runs the default pass
pipeline and returns a ``CompiledModule`` wrapping the planned executable
and its stats.  It compiles for the card unless the caller asks for the
CPU: ``device=None`` means ``"cuda"``, a missing card raises, and
``device="cpu"`` runs every kernel's plain version.  With ``mesh=`` it is a
sharded compile: the module is the per-shard body every rank of a
``torch.distributed`` world runs (``core/executor.py``).

The planner plans for the device the compile targets (``resolve_options``):
on the card the ``H100`` spec, and a slot budget of one block's shared
memory less the reduce partials of the largest block, so every ALLOC/SHARE
slot of an admitted plan lives in shared memory; on the CPU the
reference's ``TPU_V5E`` and 4 MiB, so the CPU's plans are the reference's.
``StitchOptions.device_spec`` and ``vmem_limit`` override either.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import tracing
from .codegen import StitchedKernel
from .device import resolve_device
from .executor import StitchedExecutable
from .fusion import FusionPlan, constant_like
from .latency import DeviceSpec, LatencyModel
from .measure import MeasuredCostStore, device_fingerprint
from .perf_library import PerfLibrary
from .pipeline import CompilationState, default_pipeline, resolve_options
from .schedule import REPLICATED
from .shard import mesh_axes_of
from .signature import KernelCache
from .xla_baseline import xla_baseline_kernel_count


@dataclass
class StitchOptions:
    """The reference's options minus ``interpret``: the compile's device
    takes its place."""

    fuse_dot: bool = True                    # user decision (paper §2.1)
    # the device the planner scores for and its scratch budget per kernel;
    # None: the compile's device decides (``resolve_options``)
    device_spec: Optional[DeviceSpec] = None
    vmem_limit: Optional[int] = None
    replicate_limit: int = 512 * 1024
    max_blocks: int = 4096
    ew_footprint_limit: int = 64 * 1024 * 1024
    max_fusion_ops: int = 256
    perf_library_path: Optional[str] = None
    kernel_cache_path: Optional[str] = None  # persistent tuning records
    dedup_kernels: bool = True               # fusion-signature kernel reuse
    # "cost": candidate-plan exploration under the shared LatencyModel with
    # the greedy result as the floor; "greedy": the paper's Algorithm 1.
    planner: str = "cost"
    # Multi-phase stitching: groups with no single consistent schedule
    # lower as ONE kernel of sequential phases (planner="cost" only).
    enable_stitching: bool = True
    stitch_replicate_limit: Optional[int] = None
    stitch_max_blocks: int = 64
    # Runtime replay mode: True replays each call through a CUDA graph on
    # the card (executor module docstring); False keeps the eager per-step
    # loop, which is also the CPU's path.  Runtime-only: not part of the
    # kernel-cache options fingerprint, as in the reference.
    jit_replay: bool = True
    # Measured-cost autotuning (core/measure.py): autotune=True times each
    # unique emitted kernel (warm-up + median of measure_repeats) and files
    # it in a MeasuredCostStore the planner prefers to the analytic model
    # whenever a key hits; tuning_store_path persists the store as JSON.
    # All three salt the kernel-cache options fingerprint.
    autotune: bool = False
    measure_repeats: int = 5
    tuning_store_path: Optional[str] = None
    # Shard-aware compilation: the (axis name, size) shape of the mesh the
    # plan targets, e.g. (("data", 2), ("model", 4)).  Hashable: it salts
    # the options fingerprint and the measured-store keys, while the live
    # DeviceMesh is passed to ``compile_module`` apart.  None: a
    # single-device compile, every cache key as before.
    mesh_axes: Optional[Tuple[Tuple[str, int], ...]] = None
    # Pass-boundary verification (core/verify.py): "off", "checkpoint" (the
    # finished artifact, after FinalizePass) or "strict" (after every pass).
    # The REPRO_VERIFY environment variable overrides it.  Not part of the
    # kernel-cache options fingerprint.
    verify: str = "checkpoint"

    VALID_PLANNERS = ("cost", "greedy")
    VALID_VERIFY = ("off", "checkpoint", "strict")

    def __post_init__(self):
        self.validate()

    def validate(self) -> None:
        if self.planner not in self.VALID_PLANNERS:
            raise ValueError(
                f"unknown planner {self.planner!r}; valid choices: "
                f"{', '.join(self.VALID_PLANNERS)}"
            )
        if self.verify not in self.VALID_VERIFY:
            raise ValueError(
                f"unknown verify level {self.verify!r}; valid choices: "
                f"{', '.join(self.VALID_VERIFY)}"
            )
        for name in ("vmem_limit", "replicate_limit", "max_blocks",
                     "ew_footprint_limit", "max_fusion_ops",
                     "stitch_max_blocks"):
            v = getattr(self, name)
            if v is not None and v < 0:
                raise ValueError(f"{name} must be >= 0, got {v}")
        if self.stitch_replicate_limit is not None and self.stitch_replicate_limit < 0:
            raise ValueError(
                f"stitch_replicate_limit must be >= 0 (or None), got "
                f"{self.stitch_replicate_limit}"
            )
        if self.measure_repeats < 1:
            raise ValueError(f"measure_repeats must be >= 1, got {self.measure_repeats}")
        if self.mesh_axes is not None:
            for entry in self.mesh_axes:
                name, size = entry
                if not isinstance(name, str) or int(size) < 1:
                    raise ValueError(
                        f"mesh_axes entries must be (name, size>=1) pairs, got {entry!r}"
                    )


@dataclass
class FusionReport:
    name: str
    num_ops: int
    blocks: int
    cost_s: float
    scratch_bytes: int
    shared_bytes: int
    num_shrinks: int
    roots: List[str]
    cached: bool = False                     # kernel reused via signature
    signature: str = ""
    num_phases: int = 1                      # >1 = multi-phase stitched kernel
    interface_bytes: int = 0                 # staged phase-boundary buffers
    # the analytic LatencyModel seconds, and the measurement where the
    # tuning store had (or autotune took) one; cost_s is what the planner
    # acted on
    model_cost_s: Optional[float] = None
    measured_cost_s: Optional[float] = None


@dataclass
class CompileStats:
    stitched_kernels: int
    standalone_kernels: int
    library_calls: int
    xla_baseline_kernels: int
    predicted_time_s: float
    library_time_s: float = 0.0
    reports: List[FusionReport] = field(default_factory=list)
    # loop (sub-module) accounting: ``call`` sites, unique bodies compiled,
    # call sites seen, and the kernels inside all unique bodies (recursive)
    loop_calls: int = 0
    sub_compiles: int = 0
    sub_call_sites: int = 0
    sub_kernels: int = 0
    kernel_cache_hits: int = 0               # fusion instances served by cache
    kernel_cache_misses: int = 0             # unique fusions tuned this compile
    tuning_disk_hits: int = 0                # tuning searches skipped (warm disk)
    unique_kernels: int = 0                  # distinct kernels backing the fusions
    kernels_emitted: int = 0                 # CUDA kernels emitted THIS compile
    compile_time_s: float = 0.0
    build_time_s: float = 0.0                # the build span: nvcc, or the library found, loaded
    pass_times: Dict[str, float] = field(default_factory=dict)
    planner_mode: str = "greedy"
    plans_explored: int = 0
    plans_rejected: int = 0
    planner_splits: int = 0
    planner_merges: int = 0
    planner_packs: int = 0
    planner_stitches: int = 0
    stitch_lowered_kernels: int = 0          # instances using the stitched emitter
    stitch_phases_total: int = 0
    stitch_interface_bytes: int = 0
    planner_predicted_s: float = 0.0         # modeled latency, committed plan
    greedy_predicted_s: float = 0.0          # modeled latency, floor plan
    greedy_kernels: int = 0
    planner_kernels: int = 0
    unfused_kernels: int = 0                 # launches with no fusion at all
    # runtime replay accounting (executor.LaunchStats): "sharded" for a
    # compile with a mesh; "graph" on the card with jit_replay where a
    # replayed call dispatches no more than an eager one, else "eager";
    # dispatches the eager loop makes per call, and what
    # a replayed call makes (the graph's launch and the copies)
    replay_mode: str = "graph"
    eager_dispatches_per_call: int = 0
    traced_dispatches_per_call: int = 0
    donated_buffers: int = 0                 # donated parameters whose buffer a later kernel writes
    # measured-cost autotuning (core/measure.py): store lookups this
    # compile, kernels timed this compile, and the analytic model's mean
    # relative error over every entry with both costs (None: none had both)
    measured_hits: int = 0
    measured_misses: int = 0
    measurements_taken: int = 0
    model_error_pct: Optional[float] = None
    # shard-aware compilation (zero on single-device compiles): collective
    # steps in the plan, counted apart from kernels and library calls;
    # their modeled wire time; how many sit between two fused kernels
    # (compute fused on both sides of the break); and how many
    # instructions carry a non-trivial shard layout
    collective_calls: int = 0
    collective_time_s: Optional[float] = 0.0   # None: the spec has no link numbers
    collective_breaks_spanned: int = 0
    sharded_instrs: int = 0
    # pass-boundary verification (core/verify.py)
    verify_mode: str = "off"
    verify_boundaries: int = 0
    verify_warnings: int = 0
    verify_time_s: float = 0.0
    device: str = "cuda"

    @property
    def replay_dispatch_reduction(self) -> int:
        """Dispatches a replayed call saves over the eager loop."""
        return self.eager_dispatches_per_call - self.traced_dispatches_per_call

    @property
    def fusion_ratio(self) -> float:
        """paper Fig. 7: our kernel count / XLA baseline kernel count; loop
        body kernels count as ours, as the baseline counts into bodies."""
        ours = self.stitched_kernels + self.standalone_kernels + self.sub_kernels
        return ours / self.xla_baseline_kernels if self.xla_baseline_kernels else 1.0

    @property
    def launches_saved_vs_unfused(self) -> int:
        return self.unfused_kernels - (self.stitched_kernels + self.standalone_kernels)

    @property
    def launches_saved_vs_greedy(self) -> int:
        return self.greedy_kernels - (self.stitched_kernels + self.standalone_kernels)

    @property
    def cache_hit_rate(self) -> float:
        total = self.kernel_cache_hits + self.kernel_cache_misses
        return self.kernel_cache_hits / total if total else 0.0

    @property
    def smem_average(self) -> float:
        allocs = [r.scratch_bytes for r in self.reports]
        return float(np.mean(allocs)) if allocs else 0.0

    @property
    def smem_max(self) -> int:
        return max((r.scratch_bytes for r in self.reports), default=0)

    @property
    def total_shrinks(self) -> int:
        return sum(r.num_shrinks for r in self.reports)

    @property
    def shared_ratio(self) -> float:
        tot = sum(r.scratch_bytes for r in self.reports)
        sh = sum(r.shared_bytes for r in self.reports)
        return sh / tot if tot else 0.0


class CompiledModule:
    def __init__(self, executable: StitchedExecutable, stats: CompileStats,
                 cuda_source: str = ""):
        self.executable = executable
        self.stats = stats
        self.cuda_source = cuda_source    # the compile's one .cu

    @property
    def kernels(self) -> List[StitchedKernel]:
        """One kernel per unique signature, in plan order."""
        seen, out = set(), []
        for k in self.executable.kernels.values():
            if id(k.fn) not in seen:
                seen.add(id(k.fn))
                out.append(k)
        return out

    @property
    def launched_kernels(self) -> List[StitchedKernel]:
        """``kernels``, then each loop body's (``compiled_body`` of a
        ``call``), recursively: every generated kernel a call launches, one
        per unique signature."""
        seen = {id(k.fn) for k in self.kernels}
        out = list(self.kernels)
        for s in self.executable.plan.standalone:
            if s.opcode == "call":
                for k in s.attrs["compiled_body"].launched_kernels:
                    if id(k.fn) not in seen:
                        seen.add(id(k.fn))
                        out.append(k)
        return out

    def __call__(self, feeds):
        return self.executable(feeds)


def build_outputs(state: CompilationState) -> None:
    """FinalizePass body: final FusionPlan, planned executable, stats."""
    lib = state.library
    kernels: Dict[str, StitchedKernel] = {}
    reports: List[FusionReport] = []
    predicted = 0.0
    final_fusions = []
    stitched_instances = 0
    stitch_phases_total = 0
    stitch_iface_bytes = 0
    for p in state.planned:
        kernels[p.fusion.name] = p.kernel
        final_fusions.append(p.fusion)
        predicted += p.entry.cost_s
        mem = p.entry.memory
        st = p.entry.stitched
        if st is not None:
            stitched_instances += 1
            stitch_phases_total += st.num_phases
            stitch_iface_bytes += st.interface_bytes
        reports.append(
            FusionReport(
                p.fusion.name,
                len(p.fusion.members),
                p.entry.blocks,
                p.entry.cost_s,
                mem.total_bytes,
                mem.shared_bytes,
                mem.num_shrinks,
                [r.name for r in p.fusion.roots],
                cached=p.cache_hit,
                signature=p.entry.signature,
                num_phases=st.num_phases if st is not None else 1,
                interface_bytes=st.interface_bytes if st is not None else 0,
                model_cost_s=p.entry.model_cost_s,
                measured_cost_s=p.entry.measured_cost_s,
            )
        )

    plan = FusionPlan(
        final_fusions,
        state.fusion_plan.standalone + state.demoted,
        state.module,
        planner=state.fusion_plan.planner,
    )
    library_time = 0.0
    collective_time = 0.0
    collective_calls = 0
    mesh_sizes = dict(state.options.mesh_axes or ())
    for s in plan.standalone:
        if s.opcode == "get":
            continue   # a projection of a loop output: no launch, no cost
        if s.is_collective:
            # wire traffic, not a launch: charged by the ring model and
            # reported apart from kernel and library time; None ("not
            # measured") where the spec has no link numbers
            collective_calls += 1
            if not lib.model.prices_collectives:
                collective_time = None
                continue
            g = 1
            for a in s.attrs.get("axes", ()):
                g *= mesh_sizes.get(a, 1)
            collective_time += lib.model.collective_op_time(s, g)
            continue
        if s.opcode == "call":
            # a loop costs its body's predicted time per iteration
            sub = s.attrs["compiled_body"].stats
            trip = int(s.attrs["trip_count"])
            predicted += trip * sub.predicted_time_s
            library_time += trip * sub.library_time_s
            continue
        # standalone kernels are costed as single-op launches; library-call
        # time is tracked separately (paper Fig. 6/8 methodology)
        t = lib.model.kernel_time(1, lib.model.op_time(s, REPLICATED, 1))
        if s.is_library_call:
            library_time += t
        else:
            predicted += t

    # collective breaks spanned by fused compute: a fused kernel runs
    # upstream of the collective and another downstream (transitively: the
    # value an all-reduce takes is often a library dot, the fused compute
    # one hop further)
    fused_ids = {m.id for f in final_fusions for m in f.members}

    def _reaches(start, follow) -> bool:
        seen, stack = set(), list(start)
        while stack:
            i = stack.pop()
            if i.id in seen:
                continue
            seen.add(i.id)
            if i.id in fused_ids:
                return True
            stack.extend(follow(i))
        return False

    breaks_spanned = sum(
        1 for s in plan.standalone
        if s.is_collective
        and _reaches(s.operands, lambda i: i.operands)
        and _reaches(s.users, lambda i: i.users)
    )

    executable = StitchedExecutable(
        state.module, plan, kernels, state.device, jit_replay=state.options.jit_replay,
        donate_params=state.donate_params, mesh=state.mesh,
        param_layouts=state.param_layouts, out_layouts=state.out_layouts,
    )
    st = executable.launch_stats()
    hits = sum(1 for p in state.planned if p.cache_hit)
    unfused = sum(
        1
        for i in state.module.instructions
        if i.opcode not in ("parameter", "constant", "call", "get")
        and not constant_like(i)
        and not i.is_library_call
    )
    # a loop site's no-fusion-at-all launch count is its body's, recursively
    unfused += sum(
        i.attrs["compiled_body"].stats.unfused_kernels
        for i in state.module.instructions
        if i.opcode == "call"
    )
    sub_kernels = sum(
        cm.stats.stitched_kernels + cm.stats.standalone_kernels + cm.stats.sub_kernels
        for cm in state.sub_compiled.values()
    )
    mstore = state.measured_store
    errors = [
        abs(e.model_cost_s - e.measured_cost_s) / e.measured_cost_s * 100.0
        for e in {id(p.entry): p.entry for p in state.planned}.values()
        if e.model_cost_s is not None
        and e.measured_cost_s is not None
        and e.measured_cost_s > 0.0
    ]
    pstats = state.fusion_plan.planner
    state.executable = executable
    state.stats = CompileStats(
        stitched_kernels=st.stitched_kernels,
        standalone_kernels=st.standalone_kernels,
        library_calls=st.library_calls,
        loop_calls=st.loop_calls,
        sub_compiles=len(state.sub_compiled),
        sub_call_sites=state.sub_call_sites,
        sub_kernels=sub_kernels,
        xla_baseline_kernels=xla_baseline_kernel_count(state.module),
        predicted_time_s=predicted,
        library_time_s=library_time,
        reports=reports,
        kernel_cache_hits=hits,
        kernel_cache_misses=len(state.planned) - hits,
        tuning_disk_hits=sum(1 for p in state.planned if p.tuned_from_disk),
        unique_kernels=len({id(p.entry) for p in state.planned}),
        kernels_emitted=sum(1 for p in state.planned if p.is_representative),
        build_time_s=state.build_s,
        planner_mode=pstats.mode if pstats else "greedy",
        plans_explored=pstats.plans_explored if pstats else 0,
        plans_rejected=pstats.plans_rejected if pstats else 0,
        planner_splits=pstats.splits_taken if pstats else 0,
        planner_merges=pstats.merges_taken if pstats else 0,
        planner_packs=pstats.packs_taken if pstats else 0,
        planner_stitches=pstats.stitches_taken if pstats else 0,
        stitch_lowered_kernels=stitched_instances,
        stitch_phases_total=stitch_phases_total,
        stitch_interface_bytes=stitch_iface_bytes,
        planner_predicted_s=pstats.predicted_s if pstats else 0.0,
        greedy_predicted_s=pstats.greedy_predicted_s if pstats else 0.0,
        greedy_kernels=pstats.greedy_kernels if pstats else 0,
        planner_kernels=pstats.planned_kernels if pstats else 0,
        unfused_kernels=unfused,
        replay_mode=executable.replay_mode,
        eager_dispatches_per_call=st.eager_dispatches_per_call,
        traced_dispatches_per_call=st.traced_dispatches_per_call,
        donated_buffers=st.donated_buffers,
        measured_hits=mstore.hits - state.measured_base_hits if mstore else 0,
        measured_misses=mstore.misses - state.measured_base_misses if mstore else 0,
        measurements_taken=state.measurements_taken,
        model_error_pct=float(np.mean(errors)) if errors else None,
        collective_calls=collective_calls,
        collective_time_s=collective_time,
        collective_breaks_spanned=breaks_spanned,
        sharded_instrs=state.shard_stats.get("sharded_instrs", 0),
        device=str(state.device),
    )


def compile_module(
    module,
    options: Optional[StitchOptions] = None,
    kernel_cache: Optional[KernelCache] = None,
    device=None,
    measured_store=None,
    donate_params=None,
    mesh=None,
    param_layouts=None,
    out_layouts=None,
) -> CompiledModule:
    """Compile a StitchIR module through the default pass pipeline.

    ``device`` is where the plan runs: the card (``"cuda"``, the default),
    where every generated kernel is built with nvcc and launched, or
    ``"cpu"``, where each kernel runs its plain PyTorch version.  Library
    dots run as ``torch.matmul`` in full f32: a compile for the card sets
    ``torch.backends.cuda.matmul.allow_tf32 = False``.  ``kernel_cache``
    may be shared across compiles so structurally identical fusions reuse
    tuned schedules and emitted kernels; ``measured_store`` (a
    ``core.measure.MeasuredCostStore``) likewise, so one compile's
    measurements guide the next.  When None, one is made if
    ``options.autotune`` or ``options.tuning_store_path`` asks for it,
    keyed by this device's fingerprint.  ``donate_params`` names
    parameters whose buffers the caller donates (the frontend's
    ``donate_argnums``): the eager loop writes a later kernel's output of
    a donated parameter's shape and dtype into its buffer
    (``ExecutionPlan.donations``).  Runtime-only, never part of any cache
    key.

    ``mesh``/``param_layouts``/``out_layouts`` make this a sharded compile:
    the module holds the PER-SHARD computation (as ``frontend.aten_lower.
    lower_sharded_graph`` produces it), ``mesh`` is the live
    ``DeviceMesh`` whose ranks each run the plan (``replay_mode ==
    "sharded"``), and the layouts map parameter names, and the roots in
    order, to ``core.shard`` layout tuples.  ``mesh_axes_of(mesh)`` must
    equal ``options.mesh_axes``, the hashable half that salts every cache
    key; options without ``mesh_axes`` take the mesh's.
    """
    dev = resolve_device(device)
    opts = resolve_options(options or StitchOptions(), dev)
    donate = frozenset(donate_params) if donate_params else None
    unknown = sorted((donate or frozenset()) - {p.name for p in module.parameters})
    if unknown:
        raise ValueError(f"donate_params names no parameter of {module.name!r}: {unknown}")
    if mesh is not None:
        axes = mesh_axes_of(mesh)
        if opts.mesh_axes is None:
            opts = dataclasses.replace(opts, mesh_axes=axes)
        elif tuple(tuple(e) for e in opts.mesh_axes) != axes:
            raise ValueError(
                f"options.mesh_axes {opts.mesh_axes} != the mesh's {axes}: the "
                "fingerprint must describe the mesh the plan runs on"
            )
    elif (param_layouts or out_layouts) and not opts.mesh_axes:
        raise ValueError("param_layouts/out_layouts need mesh= or options.mesh_axes")
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    with tracing.span("compile_module") as sp:
        library = PerfLibrary(opts.perf_library_path, model=LatencyModel(opts.device_spec))
        store = measured_store
        if store is None and (opts.autotune or opts.tuning_store_path):
            store = MeasuredCostStore(
                opts.tuning_store_path, device_fp=device_fingerprint(library.model.spec, dev)
            )
        state = CompilationState(
            module=module,
            options=opts,
            library=library,
            kernel_cache=(
                kernel_cache if kernel_cache is not None else KernelCache(opts.kernel_cache_path)
            ),
            device=dev,
            measured_store=store,
            measured_base_hits=store.hits if store else 0,
            measured_base_misses=store.misses if store else 0,
            donate_params=donate,
            mesh=mesh,
            param_layouts=dict(param_layouts) if param_layouts else None,
            out_layouts=list(out_layouts) if out_layouts else None,
        )
        default_pipeline().run(state)
    state.stats.compile_time_s = sp.seconds
    state.stats.pass_times = dict(state.pass_times)
    if opts.perf_library_path:
        state.library.save()
    if opts.kernel_cache_path:
        state.kernel_cache.save()
    if store is not None and opts.tuning_store_path:
        store.save()
    return CompiledModule(state.executable, state.stats, state.cuda_source)
