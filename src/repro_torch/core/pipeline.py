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
loop body, ``AutotunePass`` after codegen times each unique kernel when
``options.autotune`` asks, and ``PassPipeline`` verifies the artifact at the
boundaries ``options.verify`` names (``core/verify.py``).  The planner
passes are the reference's, decision for decision, under the reference's
device constants.  ``ShardingPass`` is a later slice (``ROADMAP.md`` queue 1,
item 14).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

from . import cuda_build
from .codegen import StitchedKernel, assemble_source, emit_fusion, emit_stitched_fusion
from .fusion import (
    FusedComputation,
    FusionConfig,
    FusionPlan,
    FusionScorer,
    deep_fuse,
)
from .ir import Instruction, Module
from .measure import measure_kernel
from .memory import MemoryInfeasible, plan_memory, plan_stitched_memory
from .perf_library import PerfLibrary
from .schedule import (
    CONSISTENT,
    PhaseSolution,
    Unsatisfiable,
    resolve_schedules,
    resolve_stitched,
    stitchable,
)
from .signature import CacheEntry, KernelCache, fusion_signature
from .tuning import TunedPlan, score, tune


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
    # (on the card) the seconds spent building it
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

        mode = resolve_verify_mode(state.options)
        verify_time = 0.0
        boundaries = 0
        warnings = 0
        for p in self.passes:
            t0 = time.perf_counter()
            p.run(state)
            state.pass_times[p.name] = time.perf_counter() - t0
            # "off" does no verification work; "checkpoint" verifies the
            # finished artifact once; "strict" checks every boundary, so a
            # violation names the pass that introduced it
            if mode == "off" or (mode == "checkpoint" and p is not self.passes[-1]):
                continue
            v0 = time.perf_counter()
            diags = verify_state(state, pass_name=p.name)
            verify_time += time.perf_counter() - v0
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
            )

        if scorer is not None:
            def consistency(roots, members) -> bool:
                # singletons must be CONSISTENT outright (a one-member
                # stitched kernel would only be demoted later)
                if len(members) == 1:
                    return scorer.verdict(members).verdict == CONSISTENT
                return scorer.fused_cost(members) is not None
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
                )
                if v.verdict != CONSISTENT:
                    return False
                try:
                    plan_memory(members, roots, v.solution, opts.vmem_limit)
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


def _stitch_replicate_limit(opts) -> int:
    """Resolved stitched-phase replicate limit (None = the scratch budget);
    an explicit 0 means "no relaxed replication" and is honored."""
    if opts.stitch_replicate_limit is None:
        return opts.vmem_limit
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
    ``interpret``), memory budgets, blocks, planner and stitching — but not
    the autotune knobs, so a store warmed with ``autotune=True`` serves a
    later read-only ``tuning_store_path`` compile."""
    srl = _stitch_replicate_limit(opts)
    return (
        f"d{torch.device(device).type}:v{opts.vmem_limit}:r{opts.replicate_limit}"
        f":b{opts.max_blocks}:p{opts.planner}"
        f":st{int(opts.enable_stitching)}:sb{opts.stitch_max_blocks}:sr{srl}:"
    )


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
                    )
                    return TunedPlan(sol, score(members, sol, state.library)), True
                except Unsatisfiable:
                    pass  # stale record — fall back to the full search
        tuned = tune(
            members,
            roots,
            state.library,
            max_blocks=opts.max_blocks,
            replicate_limit=opts.replicate_limit,
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
        )
        if st is None:
            return None
        cap = min(opts.max_blocks, opts.stitch_max_blocks)
        for k, p in enumerate(st.phases):
            tuned = tune(
                p.members,
                p.roots,
                state.library,
                max_blocks=cap,
                replicate_limit=opts.replicate_limit,
            )
            if tuned is not None:
                st.phases[k] = PhaseSolution(p.members, p.roots, tuned.solution)
        cost = state.library.model.stitched_fusion_time(st)
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
                entry.memory = plan_stitched_memory(entry.stitched, opts.vmem_limit)
            except MemoryInfeasible:
                state.demoted.extend(fusion.members)
                return False
            entry.kept_members = len(members)
            return True
        tuned: Optional[TunedPlan] = TunedPlan(entry.solution, entry.cost_s)
        dropped: List[Instruction] = []
        while tuned is not None:
            try:
                mem = plan_memory(members, roots, tuned.solution, opts.vmem_limit)
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
        state.cuda_source = assemble_source(emitted)
        if emitted and state.device.type == "cuda":
            lib, state.build_s = cuda_build.load(state.cuda_source)
            for program in emitted:
                program.load(lib)


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
        SubModulePass(), FusionPass(), SchedulePass(), MemoryPass(), CodegenPass(),
        AutotunePass(), FinalizePass(),
    ])
