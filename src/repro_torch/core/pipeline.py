"""The FusionStitching pass pipeline of the port — ``repro/core/pipeline.py``.

    FusionPass     deep fusion (§3.2) with the ScheduleConsistencyChecker
    SchedulePass   per-fusion schedule tuning (§4.3) with fusion-signature
                   kernel-cache lookup
    MemoryPass     scratch planning (§5.1) with the memory-infeasible
                   feedback loop back into tuning (shrink + retune)
    CodegenPass    CUDA C++ emission (§5.2), one kernel per unique fusion
                   signature, all of a compile's kernels in ONE .cu built
                   once with nvcc when the compile targets the card
    FinalizePass   execution-plan construction + CompileStats

Around them, as in the reference: ``SubModulePass`` first compiles every
loop body, ``ShardingPass`` stamps shard layouts before fusion when the
compile targets a mesh, ``AutotunePass`` after codegen times each unique
kernel when ``options.autotune`` asks, and ``PassPipeline`` verifies the
artifact at the boundaries ``options.verify`` names (``core/verify.py``).
The planner passes are the reference's; they plan for the resolved
``options.device_spec`` within ``options.vmem_limit``
(``compiler.resolve_options``): under ``TPU_V5E`` decision for decision
the reference's, under ``H100`` for the card (``tuning``, ``FusionScorer``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

from .. import tracing
from . import cuda_build
from .codegen import StitchedKernel, assemble_source, emit_fusion, emit_stitched_fusion
from .fusion import (
    FusedComputation,
    FusionConfig,
    FusionPlan,
    FusionScorer,
    deep_fuse,
)
from .geometry import SMEM_LIMIT, STITCHED_MAX_THREADS, reduce_part_bytes
from .ir import Instruction, Module
from .latency import H100, TPU_V5E, DeviceSpec, LatencyModel
from .measure import measure_kernel
from .memory import MemoryInfeasible, plan_memory, plan_stitched_memory
from .perf_library import PerfLibrary
from .shard import propagate_layouts
from .schedule import (
    CONSISTENT,
    Unsatisfiable,
    resolve_schedules,
    resolve_stitched,
    stitchable,
)
from .signature import CacheEntry, KernelCache, fusion_signature
from .tuning import TunedPlan, score, tune, tune_phases


#: the TPU's scratch budget per kernel (the reference's ``vmem_limit``)
TPU_VMEM_LIMIT = 4 * 1024 * 1024


def default_vmem_limit(spec: DeviceSpec) -> int:
    """The slot budget a spec plans with when the options name none: on a
    GPU one block's shared memory (``geometry.SMEM_LIMIT``) less the reduce
    partials of the largest block, else the TPU's 4 MiB."""
    if spec.is_gpu:
        return SMEM_LIMIT - reduce_part_bytes(STITCHED_MAX_THREADS)
    return TPU_VMEM_LIMIT


def resolve_options(opts, device):
    """``opts`` with the device spec and the slot budget the compile plans
    with: an explicit value wins; else ``H100`` for the card and
    ``TPU_V5E`` for the CPU, and the spec's ``default_vmem_limit``."""
    spec = opts.device_spec
    if spec is None:
        spec = H100 if torch.device(device).type == "cuda" else TPU_V5E
    limit = opts.vmem_limit if opts.vmem_limit is not None else default_vmem_limit(spec)
    if spec is opts.device_spec and limit == opts.vmem_limit:
        return opts
    return dataclasses.replace(opts, device_spec=spec, vmem_limit=limit)


@dataclass
class PlannedFusion:
    """One fusion instance bound to its (possibly shared) cache entry."""

    fusion: FusedComputation
    entry: CacheEntry
    is_representative: bool          # this instance built the entry
    kernel: Optional[StitchedKernel] = None
    tuned_from_disk: bool = False
    # the fusion body's content hash as SchedulePass hashed it, and whether
    # memory feedback later shrank this instance (the verifier's EXEC005
    # audit re-hashes unshrunk bodies against it)
    raw_signature: Optional[str] = None
    shrunk: bool = False
    # the measured-store key (options salt + the signature the planner
    # scored), under which AutotunePass files this fusion's measurement
    measure_sig: Optional[str] = None

    @property
    def cache_hit(self) -> bool:
        return not self.is_representative


@dataclass
class CompilationState:
    """The artifact every pass reads and extends."""

    module: Module
    options: "StitchOptions"              # noqa: F821 — compiler facade type
    library: PerfLibrary
    kernel_cache: KernelCache
    device: torch.device
    fusion_plan: Optional[FusionPlan] = None
    planned: List[PlannedFusion] = field(default_factory=list)
    demoted: List[Instruction] = field(default_factory=list)
    pass_times: Dict[str, float] = field(default_factory=dict)
    # filled by CodegenPass: the compile's one CUDA translation unit, and
    # (on the card) the seconds of its ``build`` span
    cuda_source: str = ""
    build_s: float = 0.0
    # autotuning: the MeasuredCostStore of this compile (None: analytic
    # costs only); its hit and miss counters accumulate across compiles that
    # share it, so FinalizePass reports the deltas from these snapshots
    measured_store: Optional[object] = None
    measured_base_hits: int = 0
    measured_base_misses: int = 0
    measurements_taken: int = 0
    # loop bodies compiled by SubModulePass, by module signature, and the
    # call sites it saw
    sub_compiled: Dict[str, object] = field(default_factory=dict)
    sub_call_sites: int = 0
    # parameter names whose buffers the caller donated (the frontend's
    # ``donate_argnums``): runtime-only, threaded to the ExecutionPlan
    donate_params: Optional[frozenset] = None
    # shard-aware compilation (``options.mesh_axes`` set): the live
    # DeviceMesh (runtime-only; its shape is fingerprinted through
    # ``options.mesh_axes``), the parameter and output layouts, and
    # ShardingPass's counters
    mesh: Optional[object] = None
    param_layouts: Optional[Dict[str, tuple]] = None
    out_layouts: Optional[List] = None
    shard_stats: Dict[str, int] = field(default_factory=dict)
    # filled by FinalizePass
    executable: Optional[object] = None
    stats: Optional[object] = None


class Pass:
    name = "pass"

    def run(self, state: CompilationState) -> None:
        raise NotImplementedError


class PassPipeline:
    def __init__(self, passes: List[Pass]):
        self.passes = list(passes)

    def run(self, state: CompilationState) -> CompilationState:
        from .verify import ERROR, VerificationError, resolve_verify_mode, verify_state

        state.options = resolve_options(state.options, state.device)
        spec = state.options.device_spec
        if state.library.model.spec != spec:
            state.library = PerfLibrary(state.library.path, model=LatencyModel(spec))
        mode = resolve_verify_mode(state.options)
        verify_time = 0.0
        boundaries = 0
        warnings = 0
        for p in self.passes:
            with tracing.span("pass." + p.name) as sp:
                p.run(state)
            state.pass_times[p.name] = sp.seconds
            # "off" does no verification work; "checkpoint" verifies the
            # finished artifact once; "strict" checks every boundary, so a
            # violation names the pass that introduced it
            if mode == "off" or (mode == "checkpoint" and p is not self.passes[-1]):
                continue
            with tracing.span("verify") as sp:
                diags = verify_state(state, pass_name=p.name)
            verify_time += sp.seconds
            boundaries += 1
            errors = [d for d in diags if d.severity == ERROR]
            warnings += len(diags) - len(errors)
            if errors:
                state.pass_times["verify"] = verify_time
                raise VerificationError(errors)
        if mode != "off":
            state.pass_times["verify"] = verify_time
            if state.stats is not None:
                state.stats.verify_mode = mode
                state.stats.verify_boundaries = boundaries
                state.stats.verify_warnings = warnings
                state.stats.verify_time_s = verify_time
        return state


# --------------------------------------------------------------------------
# Passes
# --------------------------------------------------------------------------


class SubModulePass(Pass):
    """Compile every loop body (``call`` instruction) as its own module
    through the full pipeline, for the parent's device, before the parent's
    fusion pass runs.  Bodies are deduplicated by ``module_signature``, and
    the parent's kernel cache and measured store are shared into the
    sub-compile, so identical fusions across bodies and compiles reuse one
    kernel.  A ``call`` that already carries a ``compiled_body`` is left
    alone; nested loops recurse through the sub-compile's own pass."""

    name = "submodule"

    def run(self, state: CompilationState) -> None:
        from .compiler import compile_module
        from .signature import module_signature

        for instr in state.module.instructions:
            if instr.opcode != "call" or "compiled_body" in instr.attrs:
                continue
            state.sub_call_sites += 1
            sig = module_signature(instr.attrs["body"])
            cm = state.sub_compiled.get(sig)
            if cm is None:
                cm = compile_module(
                    instr.attrs["body"], state.options,
                    kernel_cache=state.kernel_cache, device=state.device,
                    measured_store=state.measured_store,
                )
                state.sub_compiled[sig] = cm
            instr.attrs["compiled_body"] = cm
            instr.attrs["body_sig"] = sig


class ShardingPass(Pass):
    """Resolve shard layouts before fusion.

    When the compile targets a mesh (``options.mesh_axes`` set), walk the
    module once with ``shard.propagate_layouts``: derive a layout for every
    instruction from the parameter layouts, stamp non-trivial results into
    ``attrs["shard"]`` (which salts ``fusion_signature`` downstream, so the
    kernel cache never aliases per-shard and full-shape kernels), track
    pending partial sums, and validate collectives against the mesh.  A
    compile without a mesh is untouched: no attr changes, so every
    signature and cache key stays as it was.
    """

    name = "sharding"

    def run(self, state: CompilationState) -> None:
        if not state.options.mesh_axes:
            return
        state.shard_stats = propagate_layouts(
            state.module, state.options.mesh_axes, state.param_layouts
        )


class FusionPass(Pass):
    """Deep fusion with the schedule+memory consistency checker (Fig. 4),
    cost-guided by the shared LatencyModel when ``options.planner`` is
    ``"cost"`` (candidate partitions + horizontal merging)."""

    name = "fusion"

    def run(self, state: CompilationState) -> None:
        opts = state.options
        srl = _stitch_replicate_limit(opts)

        scorer = None
        if opts.planner == "cost":
            scorer = FusionScorer(
                model=state.library.model,
                replicate_limit=opts.replicate_limit,
                max_blocks=opts.max_blocks,
                vmem_limit=opts.vmem_limit,
                allow_stitch=opts.enable_stitching,
                stitch_replicate_limit=srl,
                stitch_max_blocks=opts.stitch_max_blocks,
                measured=state.measured_store,
                options_salt=_measure_salt(opts, state.device),
                mesh_axes=opts.mesh_axes or (),
            )

        if scorer is not None:
            def consistency(roots, members) -> bool:
                # singletons must be CONSISTENT outright (a one-member
                # stitched kernel would only be demoted later)
                if len(members) == 1:
                    return scorer.verdict(members).verdict == CONSISTENT
                return scorer.feasible(members)
        else:
            def consistency(roots, members) -> bool:
                # planner="greedy" is the paper's Algorithm 1 exactly: the
                # boolean SchdConsistent veto, no stitching
                v = stitchable(
                    roots,
                    members,
                    replicate_limit=opts.replicate_limit,
                    max_blocks=opts.max_blocks,
                    allow_stitch=False,
                    spec=opts.device_spec,
                )
                if v.verdict != CONSISTENT:
                    return False
                try:
                    plan_memory(members, roots, v.solution, opts.vmem_limit,
                                opts.device_spec)
                except MemoryInfeasible:
                    return False
                return True

        fcfg = FusionConfig(
            fuse_dot=opts.fuse_dot,
            ew_footprint_limit=opts.ew_footprint_limit,
            max_fusion_ops=opts.max_fusion_ops,
            consistency=consistency,
            planner=opts.planner,
            scorer=scorer,
            enable_stitching=opts.enable_stitching,
            scorer_covers_consistency=scorer is not None,
        )
        state.fusion_plan = deep_fuse(state.module, fcfg)


def default_stitch_replicate_limit(spec: DeviceSpec, vmem_limit: int) -> int:
    """How much a stitched phase may replicate when the options name no
    limit: the scratch budget on the TPU, where a phase's working set is
    staged in VMEM; on a GPU the L2 (``spec.l2_bytes``), since staged
    tensors live in the global workspace and every block re-reads a
    replicated one from the L2, never from its shared memory."""
    return spec.l2_bytes if spec.is_gpu else vmem_limit


def _stitch_replicate_limit(opts) -> int:
    """Resolved stitched-phase replicate limit (None: the spec's default);
    an explicit 0 means "no relaxed replication" and is honored."""
    if opts.stitch_replicate_limit is None:
        return default_stitch_replicate_limit(opts.device_spec, opts.vmem_limit)
    return opts.stitch_replicate_limit


def _options_fingerprint(opts, device) -> str:
    """Kernel-cache salt: ``_measure_salt`` and the autotune knobs, which
    decide which costs the planner saw (the reference's own)."""
    return (
        _measure_salt(opts, device)
        + f"at{int(opts.autotune)}:mr{opts.measure_repeats}"
        f":ts{opts.tuning_store_path or ''}:"
    )


def _measure_salt(opts, device) -> str:
    """Options salt for measured-store keys: everything that changes what a
    kernel IS — the device it runs on (in place of the reference's
    ``interpret``), the spec it was planned for, memory budgets, blocks,
    planner and stitching — but not
    the autotune knobs, so a store warmed with ``autotune=True`` serves a
    later read-only ``tuning_store_path`` compile."""
    opts = resolve_options(opts, device)
    srl = _stitch_replicate_limit(opts)
    salt = (
        f"d{torch.device(device).type}:v{opts.vmem_limit}:r{opts.replicate_limit}"
        f":b{opts.max_blocks}:p{opts.planner}"
        f":st{int(opts.enable_stitching)}:sb{opts.stitch_max_blocks}:sr{srl}:"
    )
    # the spec the planner scored with: any but the reference's enters the
    # salt, so no kernel-cache or measured-store entry serves two specs
    if opts.device_spec is not None and opts.device_spec != TPU_V5E:
        salt += f"s{opts.device_spec.fingerprint()}:"
    # the mesh shape enters the salt only for sharded compiles: per-shard
    # costs measured on a 4-way mesh must not serve an 8-way (or unsharded)
    # run, while every single-device key stays as it was
    if opts.mesh_axes:
        salt += "m" + ",".join(f"{a}{s}" for a, s in opts.mesh_axes) + ":"
    return salt


class SchedulePass(Pass):
    """Tune each fusion's schedule; deduplicate by fusion signature."""

    name = "schedule"

    def run(self, state: CompilationState) -> None:
        opts = state.options
        cache = state.kernel_cache
        salt = _options_fingerprint(opts, state.device)
        msalt = _measure_salt(opts, state.device)
        for fusion in state.fusion_plan.fusions:
            raw = fusion_signature(fusion)
            sig = salt + raw
            # measurements are keyed by the signature the PLANNER scored
            # (pre-absorption where the two differ): what the next
            # compile's scorer will ask the store for
            msig = msalt + (fusion.scored_signature or raw)
            if opts.dedup_kernels:
                entry = cache.get(sig)
                if entry is not None:
                    state.planned.append(PlannedFusion(
                        fusion, entry, False, measure_sig=msig, raw_signature=raw))
                    continue
            tuned, from_disk = self._tune(state, fusion, sig)
            if tuned is None:
                entry = None
                if (
                    opts.enable_stitching
                    and opts.planner == "cost"
                    and len(fusion.members) > 1
                ):
                    entry = self._tune_stitched(state, fusion, sig)
                if entry is None:
                    state.demoted.extend(fusion.members)
                    continue
                self._apply_measured(state, entry, msig)
                if opts.dedup_kernels:
                    cache.put(entry)
                state.planned.append(PlannedFusion(
                    fusion, entry, True, measure_sig=msig, raw_signature=raw))
                continue
            entry = CacheEntry(
                signature=sig,
                solution=tuned.solution,
                memory=None,
                cost_s=tuned.cost_s,
                root_scheds=[tuned.solution.root_scheds[r.id] for r in fusion.roots],
                model_cost_s=tuned.cost_s,
            )
            self._apply_measured(state, entry, msig)
            if opts.dedup_kernels:
                cache.put(entry)
            state.planned.append(PlannedFusion(
                fusion, entry, True, tuned_from_disk=from_disk, measure_sig=msig,
                raw_signature=raw))

    @staticmethod
    def _apply_measured(state, entry: CacheEntry, msig: str) -> None:
        """On a measured-store hit the entry's cost becomes the measured
        time (the analytic one stays in ``model_cost_s``); on a miss nothing
        changes and AutotunePass measures the emitted kernel."""
        store = state.measured_store
        if store is None:
            return
        rec = store.get(msig)
        if rec is not None:
            entry.measured_cost_s = rec.cost_s
            entry.cost_s = rec.cost_s

    def _tune(self, state, fusion, sig):
        opts = state.options
        members, roots = fusion.members, fusion.roots
        if opts.dedup_kernels:
            hint = state.kernel_cache.tuning_hint(sig)
            if hint is not None and len(hint) == len(roots):
                try:
                    sol = resolve_schedules(
                        members,
                        roots,
                        {r.id: s for r, s in zip(roots, hint, strict=False)},
                        opts.replicate_limit,
                        opts.device_spec,
                    )
                    return TunedPlan(sol, score(members, sol, state.library,
                                                vmem_limit=opts.vmem_limit)), True
                except Unsatisfiable:
                    pass  # stale record — fall back to the full search
        tuned = tune(
            members,
            roots,
            state.library,
            max_blocks=opts.max_blocks,
            replicate_limit=opts.replicate_limit,
            vmem_limit=opts.vmem_limit,
        )
        return tuned, False

    def _tune_stitched(self, state, fusion, sig) -> Optional[CacheEntry]:
        """No single schedule exists: resolve a multi-phase stitched plan
        from the FINAL members and tune each phase (see the reference)."""
        opts = state.options
        members, roots = fusion.members, fusion.roots
        st = resolve_stitched(
            members,
            roots,
            replicate_limit=opts.replicate_limit,
            max_blocks=opts.max_blocks,
            stitch_replicate_limit=_stitch_replicate_limit(opts),
            stitch_max_blocks=opts.stitch_max_blocks,
            spec=opts.device_spec,
        )
        if st is None:
            return None
        st = tune_phases(st, state.library, min(opts.max_blocks, opts.stitch_max_blocks),
                         opts.replicate_limit, opts.vmem_limit)
        mem = None
        if opts.device_spec.is_gpu:
            try:
                mem = plan_stitched_memory(st, opts.vmem_limit, opts.device_spec)
            except MemoryInfeasible:
                pass   # MemoryPass demotes it
        cost = state.library.model.stitched_fusion_time(st, mem)
        return CacheEntry(
            signature=sig,
            solution=None,
            memory=None,
            cost_s=cost,
            stitched=st,
            model_cost_s=cost,
        )


class MemoryPass(Pass):
    """Scratch planning with the §5.1.2 feedback loop: on MemoryInfeasible,
    drop the deepest member, re-tune, retry.  Dropped members are demoted
    to standalone kernels."""

    name = "memory"

    def run(self, state: CompilationState) -> None:
        dead = set()  # entries whose representative proved unfusable
        kept: List[PlannedFusion] = []
        for p in state.planned:
            if not p.is_representative:
                if id(p.entry) in dead:
                    state.demoted.extend(p.fusion.members)
                    continue
                kept.append(p)
                continue
            if self._plan(state, p):
                kept.append(p)
            else:
                dead.add(id(p.entry))
                if state.options.dedup_kernels:
                    state.kernel_cache.remove(p.entry.signature)
        state.planned = kept

    def _plan(self, state, p: PlannedFusion) -> bool:
        opts = state.options
        fusion, entry = p.fusion, p.entry
        members, roots = fusion.members, fusion.roots
        if entry.stitched is not None:
            try:
                entry.memory = plan_stitched_memory(entry.stitched, opts.vmem_limit,
                                                    opts.device_spec)
            except MemoryInfeasible:
                state.demoted.extend(fusion.members)
                return False
            entry.kept_members = len(members)
            return True
        tuned: Optional[TunedPlan] = TunedPlan(entry.solution, entry.cost_s)
        dropped: List[Instruction] = []
        while tuned is not None:
            try:
                mem = plan_memory(members, roots, tuned.solution, opts.vmem_limit,
                                  opts.device_spec)
            except MemoryInfeasible:
                if len(members) <= 1:
                    tuned = None
                    break
                dropped.append(members[-1])
                members = members[:-1]
                fusion = FusedComputation(members, name=fusion.name)
                roots = fusion.roots
                tuned = tune(
                    members,
                    roots,
                    state.library,
                    max_blocks=opts.max_blocks,
                    replicate_limit=opts.replicate_limit,
                    vmem_limit=opts.vmem_limit,
                )
                continue
            state.demoted.extend(dropped)
            if dropped:
                p.shrunk = True
            p.fusion = fusion
            entry.solution = tuned.solution
            entry.cost_s = tuned.cost_s
            if dropped:
                # the structure changed: the pre-shrink costs describe another
                entry.model_cost_s = tuned.cost_s
                entry.measured_cost_s = None
            entry.memory = mem
            entry.root_scheds = [tuned.solution.root_scheds[r.id] for r in roots]
            entry.kept_members = len(members)
            if dropped and opts.dedup_kernels:
                state.kernel_cache.discard_disk(entry.signature)
            return True
        state.demoted.extend(fusion.members)
        state.demoted.extend(dropped)
        return False


class CodegenPass(Pass):
    """Emit one CUDA kernel per unique signature and bind instances.

    Every kernel this compile emits goes into ONE translation unit; a
    compile for the card builds it (or finds it built) and binds each
    kernel's launcher, a compile for the CPU keeps the source and runs the
    plain versions.
    """

    name = "codegen"

    def run(self, state: CompilationState) -> None:
        emitted = []
        for p in state.planned:
            entry = p.entry
            if p.is_representative:
                if entry.stitched is not None:
                    kernel = emit_stitched_fusion(p.fusion, entry.stitched, entry.memory)
                else:
                    kernel = emit_fusion(p.fusion, entry.solution, entry.memory)
                entry.kernel = kernel
                p.kernel = kernel
                emitted.append(kernel.fn)
            else:
                # the representative may have shrunk under memory feedback;
                # apply the identical shrink to this instance before binding
                kept_n = entry.kept_members or len(p.fusion.members)
                if kept_n < len(p.fusion.members):
                    state.demoted.extend(p.fusion.members[kept_n:])
                    p.shrunk = True
                    p.fusion = FusedComputation(p.fusion.members[:kept_n], name=p.fusion.name)
                p.kernel = entry.kernel.bind(p.fusion)
        tracing.count("schedule.index_values", sum(_index_values(p.entry) for p in state.planned))
        state.cuda_source = assemble_source(emitted)
        if emitted and state.device.type == "cuda":
            lib, state.build_s = cuda_build.load(state.cuda_source)
            for program in emitted:
                program.load(lib)


def _index_values(entry: CacheEntry) -> int:
    """Members of a committed fusion that its schedule let past the replicate
    limit as values computed from indices alone (``resolve_schedules``)."""
    sols = [ph.solution for ph in entry.stitched.phases] if entry.stitched else [entry.solution]
    return sum(len(s.index_values) for s in sols)


class AutotunePass(Pass):
    """Measure each unique emitted kernel once and remember the result.

    Runs after CodegenPass, only when ``options.autotune`` is set: each
    representative whose measured-store lookup missed is timed on the
    compile's device (``measure.measure_kernel``: CUDA events on the card,
    the plain version's wall clock on the CPU) and filed under its measure
    key, so the NEXT compile's scorer and SchedulePass see it.  This
    compile's plan is already committed: the loop closes across compiles."""

    name = "autotune"

    def run(self, state: CompilationState) -> None:
        store = state.measured_store
        if store is None or not state.options.autotune:
            return
        repeats = state.options.measure_repeats
        for p in state.planned:
            if not p.is_representative or p.kernel is None:
                continue
            entry = p.entry
            if entry.measured_cost_s is not None:
                continue  # a store hit, or measured already this compile
            t = measure_kernel(p.kernel, state.device, repeats=repeats)
            model_s = entry.model_cost_s if entry.model_cost_s is not None else entry.cost_s
            store.put(p.measure_sig, t, model_s=model_s, repeats=repeats)
            entry.measured_cost_s = t
            state.measurements_taken += 1


class FinalizePass(Pass):
    """Assemble the final FusionPlan, the planned executable, and stats."""

    name = "finalize"

    def run(self, state: CompilationState) -> None:
        from .compiler import build_outputs  # the facade above this module

        build_outputs(state)


def default_pipeline() -> PassPipeline:
    return PassPipeline([
        SubModulePass(), ShardingPass(), FusionPass(), SchedulePass(), MemoryPass(),
        CodegenPass(), AutotunePass(), FinalizePass(),
    ])
