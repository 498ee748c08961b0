"""Deep fusion — paper §3.2 (ElementwiseFusion + Algorithm 1) — grown into a
**cost-guided fusion planner**.

The driver walks layers bottom-up (span 0 upward).  At each *root layer* it
first performs intra-layer ElementwiseFusion (horizontal fusion of
independent same-shape elementwise ops — the weight-accumulation pattern in
training graphs), then runs Algorithm 1 from every fusion seed in the layer,
fusing producer instructions layer-by-layer up to the *roof* (the next
library-call layer).

``SchdConsistent`` is injected by the compiler pipeline: it asks the schedule
planner whether an optimized schedule still exists for the enlarged fusion,
and the memory planner's infeasibility feedback arrives through the same
callable (paper §5.1.2 — "a feedback signal is generated back to
ScheduleConsistencyChecker").

**Planner (follow-up work, arXiv:2009.10924 / 2301.13062):** the original
paper *accepts or rejects* each greedy enlargement with a boolean check; the
successor systems show the real wins come from evaluating alternative fusion
plans under an analytic latency model and keeping the cheapest.  With
``FusionConfig.planner == "cost"``, each greedy-maximal seed result becomes
one *candidate partition* among several (split-at-reduce,
split-before-broadcast, no-fuse), every candidate is scored with the shared
``LatencyModel`` (``core/latency.py``) through a ``FusionScorer``, and the
cheapest feasible partition is committed.  A final **horizontal-merge** pass
packs independent fusions with matching root shapes into one kernel when the
model says the saved launches beat the packing cost.  The greedy result is
always in the candidate set, so the planner is never worse than greedy
*under the model* (the floor property; tested in ``tests/test_planner.py``).
``planner == "greedy"`` reproduces the paper's original behavior exactly.

**Stitching (arXiv:1911.11576 / 2009.10924):** the
injected SchdConsistent callable now accepts groups whose only lowering is
a multi-phase *stitched* kernel (``schedule.stitchable``'s three-way
verdict), the scorer charges those through
``LatencyModel.stitched_fusion_time``, committed stitched groups carry
their phase structure in ``FusedComputation.stitch_phases`` (which salts
the fusion signature), and independent same-layer sink towers are grown
separately then scored as ONE *packed* kernel against the per-tower floor
(``_sink_pack_groups`` / ``_choose_pack``) — the ReduceTowers/BcastHeavy
pathology reaches a single kernel at planning time instead of relying on
the horizontal-merge post-pass.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Set, Tuple

from .ir import Instruction, Module
from .latency import LatencyModel
from .memory import MemoryInfeasible, plan_memory, plan_stitched_memory
from .perf_library import PerfLibrary
from .schedule import CONSISTENT, STITCHABLE, StitchVerdict, stitchable
from .tuning import kernel_fits, tune_kernel, tune_phases
from . import span as span_lib

# Opcodes that may live inside a fused computation.  Collectives
# (ir.COLLECTIVE_OPCODES) are deliberately absent: an all_reduce
# synchronizes the mesh, so it is a hard schedule break — compute on each
# side fuses into its own kernel and the collective stays a standalone
# step, the same way PR 3's phase machinery breaks at VMEM interfaces.
FUSABLE_OPCODES = frozenset(
    {
        "elementwise", "select", "reshape", "bitcast", "transpose",
        "broadcast", "reduce", "concat", "gather", "iota", "constant",
        "slice", "cumsum",
    }
)

# A broadcast that expands its operand at least this much marks a
# replication boundary the planner may split at.
_BCAST_EXPAND_FACTOR = 8


def fusable_member(instr: Instruction, fuse_dot: bool) -> bool:
    if instr.opcode == "dot":
        return fuse_dot and instr.attrs.get("fusable", False)
    if instr.opcode == "constant":
        # Pallas kernel bodies can only inline SCALAR constants (an array
        # would be a captured closure constant, which pallas_call rejects);
        # array constants stay kernel inputs, folded once at plan-build
        # time into the executor's buffer template.
        return instr.num_elements == 1
    return instr.opcode in FUSABLE_OPCODES


def constant_like(instr: Instruction) -> bool:
    """Constant-derived data-movement chains (constant/iota + shape ops over
    them).  These never launch a kernel — XLA folds them — and the paper
    inlines trivial ops via thread composition; they are absorbed into any
    consumer fusion regardless of layer roofs and never counted standalone.

    Memoized on the instruction (operands are immutable after construction):
    the naive recursion is exponential on shared-operand DAG chains.
    """
    cached = getattr(instr, "_constant_like", None)
    if cached is not None:
        return cached
    if instr.opcode in ("constant", "iota"):
        result = True
    elif instr.opcode in ("broadcast", "reshape", "bitcast", "transpose", "slice"):
        result = all(constant_like(o) for o in instr.operands)
    else:
        result = False
    instr._constant_like = result
    return result


@dataclass
class FusedComputation:
    """A group of instructions emitted as ONE stitched kernel."""

    members: List[Instruction]           # topological order
    name: str = "fusion"
    modeled_cost_s: Optional[float] = None   # planner's LatencyModel estimate
    # Phase structure (member count per phase) when the planner committed
    # this group as a multi-phase stitched lowering; None = single-schedule.
    # Salts the fusion signature so stitched and split lowerings never alias
    # in the kernel cache.
    stitch_phases: Optional[Tuple[int, ...]] = None
    # Signature of the member set the planner actually SCORED, when the
    # constant-absorption post-pass grew the group afterwards.  Measured-cost
    # records must be keyed by this (the scorer's lookup key on the next
    # compile), not by the post-absorption structure; None = they coincide.
    scored_signature: Optional[str] = None

    def __post_init__(self):
        ids = {m.id for m in self.members}
        self._ids = ids

    def __contains__(self, instr: Instruction) -> bool:
        return instr.id in self._ids

    @property
    def roots(self) -> List[Instruction]:
        """Outputs: members used outside the fusion (or module sinks)."""
        out = []
        for m in self.members:
            if not m.users or any(u.id not in self._ids for u in m.users):
                out.append(m)
        return out

    @property
    def inputs(self) -> List[Instruction]:
        seen, out = set(), []
        for m in self.members:
            for op in m.operands:
                if op.id not in self._ids and op.id not in seen:
                    seen.add(op.id)
                    out.append(op)
        return out

    def footprint_bytes(self) -> int:
        return sum(i.bytesize for i in self.inputs) + sum(
            r.bytesize for r in self.roots
        )

    def __repr__(self):
        return (
            f"FusedComputation({self.name}: {len(self.members)} ops, "
            f"roots={[r.name for r in self.roots]})"
        )


@dataclass
class PlannerStats:
    """What the cost-guided planner did, for CompileStats / benchmarks."""

    mode: str = "greedy"
    plans_explored: int = 0        # candidate partitions scored (incl. greedy)
    plans_rejected: int = 0        # candidates with no feasible schedule/memory
    splits_taken: int = 0          # seeds committed as a non-greedy partition
    merges_taken: int = 0          # horizontal merges applied
    packs_taken: int = 0           # sink groups committed as ONE packed kernel
    stitches_taken: int = 0        # groups committed with multi-phase lowering
    # The "greedy floor": per-seed whole-group commits under the SAME
    # consistency regime as the planner (including stitching when enabled).
    # This is the plan the floor property guarantees we never exceed.  It is
    # NOT the paper-exact greedy on stitched graphs — there a seed grows
    # across breaks that planner="greedy" would refuse, so compile with
    # planner="greedy" (as bench_fusion_planner does) for that comparison.
    greedy_kernels: int = 0        # kernels the floor plan would launch
    planned_kernels: int = 0       # kernels the committed plan launches
    predicted_s: float = 0.0       # modeled latency of the committed plan
    greedy_predicted_s: float = 0.0  # modeled latency of the floor plan

    @property
    def launches_saved_vs_greedy(self) -> int:
        return self.greedy_kernels - self.planned_kernels


@dataclass
class FusionPlan:
    fusions: List[FusedComputation]
    standalone: List[Instruction]        # unfused kernel launches (incl. LC dots)
    module: Module
    planner: Optional[PlannerStats] = None

    @property
    def num_kernels(self) -> int:
        """Kernel launches excluding library calls and collectives (the
        paper's Fig-7 metric; collectives are ICI traffic, not launches)."""
        return len(self.fusions) + sum(
            1
            for s in self.standalone
            if not s.is_library_call and not s.is_collective
        )

    @property
    def num_library_calls(self) -> int:
        return sum(1 for s in self.standalone if s.is_library_call)

    @property
    def num_collectives(self) -> int:
        return sum(1 for s in self.standalone if s.is_collective)


def _always_consistent(roots: List[Instruction], members: List[Instruction]) -> bool:
    return True


@dataclass
class FusionConfig:
    fuse_dot: bool = True                 # user decision, paper §2.1
    ew_footprint_limit: int = 64 * 1024 * 1024   # ElementwiseFusion threshold
    max_fusion_ops: int = 256
    # SchdConsistent(roots, tentative_members) -> bool.  Injected by the
    # compiler; defaults to permissive for structural tests.
    consistency: Callable[[List[Instruction], List[Instruction]], bool] = (
        _always_consistent
    )
    # "cost": candidate-partition exploration under the LatencyModel (with
    # the greedy result as the floor).  "greedy": the paper's Algorithm 1
    # accept/reject, exactly as before.
    planner: str = "cost"
    # Multi-phase stitching (arXiv:1911.11576 / 2009.10924): lets the cost
    # planner pack independent same-layer sinks into one kernel and commit
    # groups with no single consistent schedule as phase-stitched lowerings.
    enable_stitching: bool = True
    # Scorer shared with the rest of the compile (built from the pipeline's
    # PerfLibrary model + StitchOptions limits); a default one is
    # constructed when the planner runs without a pipeline.
    scorer: Optional["FusionScorer"] = None
    # True when ``consistency`` is exactly the scorer's own feasibility
    # check (any_satisfiable + plan_memory under the same limits) — the
    # pipeline sets this so planner commits skip the duplicate solve.
    # Custom checkers injected by direct deep_fuse callers keep the veto.
    scorer_covers_consistency: bool = False


class FusionScorer:
    """Scores candidate partitions for the cost-guided planner.

    Feasibility uses the same machinery the pipeline's consistency checker
    uses (the three-way ``stitchable`` verdict + the matching memory plan);
    the time estimate is the shared ``LatencyModel`` — ``fusion_time`` for
    schedule-consistent groups, ``stitched_fusion_time`` (which charges the
    interface staging traffic and phase-loop overhead) for groups that only
    lower as multi-phase stitched kernels.  Scores are memoized by member-id
    frozenset — candidate partitions overlap heavily (the greedy group
    reappears inside every merge attempt).

    When a ``measured`` store is attached (autotuning), a feasible group's
    cost is replaced by the remembered on-device time whenever the group's
    salted signature hits the store; the analytic number stays the cold-start
    prior.  Feasibility itself NEVER consults measurements — an infeasible
    group stays None no matter what the store claims — so a warm store can
    flip plan *choices* but never plan *validity*.

    On a GPU (``model.spec.is_gpu``) a group is scored as the kernel the
    pipeline would build from it: the tuned schedule whose memory plan fits
    ``vmem_limit`` (``tuning.tune_kernel``; stitched phases tuned as
    ``SchedulePass`` tunes them), since the schedule decides the grid and
    so the share of the card the kernel fills.  A group none of whose
    schedules fits is infeasible.
    """

    def __init__(
        self,
        model: Optional[LatencyModel] = None,
        replicate_limit: int = 512 * 1024,
        max_blocks: int = 4096,
        vmem_limit: int = 4 * 1024 * 1024,
        allow_stitch: bool = True,
        stitch_replicate_limit: Optional[int] = None,
        stitch_max_blocks: int = 64,
        measured=None,
        options_salt: str = "",
        mesh_axes: Tuple[Tuple[str, int], ...] = (),
    ):
        self.model = model or LatencyModel()
        self.mesh_axes = dict(mesh_axes)
        # MeasuredCostStore (duck-typed: .get(sig) -> obj with .cost_s, or
        # None) — fusion.py cannot import core.measure (signature.py sits
        # between them in the import graph).
        self.measured = measured
        self.options_salt = options_salt
        self.replicate_limit = replicate_limit
        self.max_blocks = max_blocks
        self.vmem_limit = vmem_limit
        self.allow_stitch = allow_stitch
        self.stitch_replicate_limit = (
            vmem_limit if stitch_replicate_limit is None else stitch_replicate_limit
        )
        self.stitch_max_blocks = stitch_max_blocks
        self.spec = self.model.spec
        self._lib = PerfLibrary(model=self.model)   # the GPU scorer's tuner
        self._memo: Dict[frozenset, Optional[float]] = {}
        self._verdicts: Dict[frozenset, StitchVerdict] = {}
        self._fits: Dict[frozenset, bool] = {}

    def standalone_cost(self, instr: Instruction) -> float:
        if instr.is_collective:
            g = 1
            for a in instr.attrs.get("axes", ()):
                g *= self.mesh_axes.get(a, 1)
            return self.model.collective_op_time(instr, g)
        return self.model.standalone_time(instr)

    def verdict(self, members: List[Instruction]) -> StitchVerdict:
        """Memoized three-way schedule verdict for a member set."""
        key = frozenset(m.id for m in members)
        if key not in self._verdicts:
            roots = FusedComputation(list(members), name="candidate").roots
            self._verdicts[key] = stitchable(
                roots,
                members,
                replicate_limit=self.replicate_limit,
                max_blocks=self.max_blocks,
                stitch_replicate_limit=self.stitch_replicate_limit,
                stitch_max_blocks=self.stitch_max_blocks,
                allow_stitch=self.allow_stitch,
                spec=self.spec,
            )
        return self._verdicts[key]

    def stitch_phases_for(
        self, members: List[Instruction]
    ) -> Optional[Tuple[int, ...]]:
        """Phase structure the committed group will lower with, or None for
        single-schedule groups.  Only consults the memo — never solves."""
        v = self._verdicts.get(frozenset(m.id for m in members))
        if v is not None and v.verdict == STITCHABLE and v.stitched is not None:
            return v.stitched.phase_sizes
        return None

    def feasible(self, members: List[Instruction]) -> bool:
        """Whether ``fused_cost`` is not None, without costing a single
        schedule kernel on a GPU (``tuning.kernel_fits``): a fusion's growth
        asks this of every enlargement, and the cost only of what it keeps."""
        key = frozenset(m.id for m in members)
        if key in self._memo:
            return self._memo[key] is not None
        if len(members) > 1 and self.spec.is_gpu:
            v = self.verdict(members)
            if v.verdict != CONSISTENT:
                return self.fused_cost(members) is not None
            if key not in self._fits:
                roots = FusedComputation(list(members), name="candidate").roots
                self._fits[key] = kernel_fits(members, roots, self._lib, self.max_blocks,
                                              self.replicate_limit, self.vmem_limit)
            return self._fits[key]
        return self.fused_cost(members) is not None

    def fused_cost(self, members: List[Instruction]) -> Optional[float]:
        """Modeled seconds for ``members`` as ONE kernel; None = infeasible."""
        key = frozenset(m.id for m in members)
        if key not in self._memo:
            self._memo[key] = self._fused_cost(members)
        return self._memo[key]

    def _fused_cost(self, members: List[Instruction]) -> Optional[float]:
        fusion = FusedComputation(list(members), name="candidate")
        if len(members) == 1:
            return self._maybe_measured(fusion, self.standalone_cost(members[0]))
        roots = fusion.roots
        v = self.verdict(members)
        if self.spec.is_gpu:
            return self._gpu_cost(fusion, members, roots, v)
        if v.verdict == CONSISTENT:
            try:
                plan_memory(members, roots, v.solution, self.vmem_limit, self.spec)
            except MemoryInfeasible:
                return None
            return self._maybe_measured(
                fusion, self.model.fusion_time(members, roots, v.solution)
            )
        if v.verdict == STITCHABLE:
            try:
                plan_stitched_memory(v.stitched, self.vmem_limit, self.spec)
            except MemoryInfeasible:
                return None
            # Sign the candidate with the phase structure it would lower
            # with, so its store key matches the committed stitched kernel's.
            fusion.stitch_phases = v.stitched.phase_sizes
            return self._maybe_measured(
                fusion, self.model.stitched_fusion_time(v.stitched)
            )
        return None

    def _gpu_cost(self, fusion, members, roots, v) -> Optional[float]:
        lib = self._lib
        if v.verdict == CONSISTENT:
            found = tune_kernel(members, roots, lib, self.max_blocks,
                                self.replicate_limit, self.vmem_limit)
            if found is None:
                return None
            tuned, mem = found
            return self._maybe_measured(
                fusion, self.model.fusion_time(members, roots, tuned.solution, mem)
            )
        if v.verdict == STITCHABLE:
            st = tune_phases(v.stitched, lib, min(self.max_blocks, self.stitch_max_blocks),
                             self.replicate_limit, self.vmem_limit)
            try:
                mem = plan_stitched_memory(st, self.vmem_limit, self.spec)
            except MemoryInfeasible:
                return None
            fusion.stitch_phases = st.phase_sizes
            return self._maybe_measured(fusion, self.model.stitched_fusion_time(st, mem))
        return None

    def _maybe_measured(
        self, fusion: FusedComputation, analytic: float
    ) -> float:
        """Measured seconds when the store knows this lowering, else the
        analytic prior.  Called only on FEASIBLE groups."""
        if self.measured is None:
            return analytic
        from .signature import fusion_signature  # local: signature imports us

        rec = self.measured.get(self.options_salt + fusion_signature(fusion))
        return rec.cost_s if rec is not None else analytic

    def partition_cost(
        self, groups: List[List[Instruction]]
    ) -> Optional[List[float]]:
        """Per-group modeled cost, or None if any group is infeasible."""
        out = []
        for g in groups:
            c = self.fused_cost(g)
            if c is None:
                return None
            out.append(c)
        return out


def _topo_sorted(members: Set[Instruction], module: Module) -> List[Instruction]:
    ids = {m.id for m in members}
    return [i for i in module.instructions if i.id in ids]


def _elementwise_groups(
    layer: List[Instruction], assigned: Set[int], cfg: FusionConfig
) -> List[List[Instruction]]:
    """Group independent same-layer elementwise ops by output shape, chunked
    by the footprint threshold (paper §3.2 ElementwiseFusion)."""
    by_shape: Dict[tuple, List[Instruction]] = {}
    for instr in layer:
        if instr.id in assigned or not instr.is_elementwise:
            continue
        by_shape.setdefault((instr.shape, str(instr.dtype)), []).append(instr)
    groups = []
    for _, instrs in sorted(by_shape.items(), key=lambda kv: str(kv[0])):
        cur, cur_bytes = [], 0
        for i in instrs:
            fp = i.footprint_bytes()
            if cur and cur_bytes + fp > cfg.ew_footprint_limit:
                groups.append(cur)
                cur, cur_bytes = [], 0
            cur.append(i)
            cur_bytes += fp
        if cur:
            groups.append(cur)
    # Only multi-op groups constitute a horizontal fusion seed.
    return [g for g in groups if len(g) >= 2]


def _reaches(stack: List[Instruction], fused: Set[Instruction],
             group_of: Optional[Dict[int, Tuple[Instruction, ...]]]) -> bool:
    """Whether a path from the outside instructions on ``stack`` reaches a
    member of ``fused``.  A committed group (``group_of``: instruction id ->
    its group's members) runs as one kernel, after every input of every
    member: a path into one member goes on from the users of all of them."""
    seen: Set[int] = set()
    while stack:
        n = stack.pop()
        if n.id in seen:
            continue
        for g in (group_of or {}).get(n.id, (n,)):
            seen.add(g.id)
            for u in g.users:
                if u in fused:
                    return True
                if u.id not in seen:
                    stack.append(u)
    return False


def _would_cycle(hlo: Instruction, fused: Set[Instruction]) -> bool:
    """True if fusing ``hlo`` creates a dependence cycle: a path from
    ``hlo`` through outside-the-fusion consumers back to an input of the
    fusion.  (The paper collapses fusions into single HLO instructions after
    each pass, which makes such cycles visible structurally; with virtual
    groups we check reachability explicitly.)  The path is walked over
    instructions, not over the other groups: ``_break_cycles`` repairs a
    cycle that only the groups close."""
    return _reaches([u for u in hlo.users if u not in fused], fused, None)


def subgraph_fuse(
    seed: List[Instruction],
    module: Module,
    span: Dict[int, int],
    layer_map: Dict[int, List[Instruction]],
    roof: int,
    assigned: Set[int],
    cfg: FusionConfig,
) -> List[Instruction]:
    """Algorithm 1: fuse producers layer-by-layer from the seed up to roof."""
    fused: Set[Instruction] = set(seed)
    giveup: Set[Instruction] = set()
    roots = list(seed)
    curr_span = max(span[s.id] for s in seed)
    # The roof layer's NON-library ops are fusable (only the library call
    # itself is a boundary); constant-like producers get a final absorption
    # pass below, unbounded by roofs.
    for lvl in range(curr_span + 1, roof + 1):
        for hlo in layer_map.get(lvl, ()):
            if hlo.id in assigned or hlo in fused:
                continue
            if not fusable_member(hlo, cfg.fuse_dot):
                continue
            if len(fused) >= cfg.max_fusion_ops:
                return _topo_sorted(fused, module)
            # --- SchdConsistent (paper §3.2) -----------------------------
            if any(u in giveup for u in hlo.users):
                giveup.add(hlo)            # poisoned: avoid dependence loops
                continue
            if not any(u in fused for u in hlo.users):
                continue                   # producer/consumer fusion only
            if _would_cycle(hlo, fused):
                giveup.add(hlo)
                continue
            tentative = _topo_sorted(fused | {hlo}, module)
            if cfg.consistency(roots, tentative):
                fused.add(hlo)
            else:
                giveup.add(hlo)
    return _topo_sorted(fused, module)


# --------------------------------------------------------------------------
# Candidate-partition exploration (the cost-guided planner)
# --------------------------------------------------------------------------


def _candidate_partitions(
    members: List[Instruction],
) -> List[Tuple[str, List[List[Instruction]]]]:
    """Alternative partitions of one greedy-maximal member set.

    Every partition cuts ``members`` (module-topological order) into
    contiguous runs, which can never introduce a group-level cycle: a run
    only depends on earlier runs and on values outside the set.
    """
    cands: List[Tuple[str, List[List[Instruction]]]] = [("greedy", [members])]
    if len(members) == 1:
        return cands

    # split AFTER each reduce (or running sum): the reduce ends its group,
    # so its consumers (typically a broadcast back to the wide shape) start
    # a fresh kernel — the anti-over-fusion cut from the follow-up papers.
    groups: List[List[Instruction]] = []
    cur: List[Instruction] = []
    for m in members:
        cur.append(m)
        if m.opcode in ("reduce", "cumsum"):
            groups.append(cur)
            cur = []
    if cur:
        groups.append(cur)
    if len(groups) > 1:
        cands.append(("split_reduce", groups))

    # split BEFORE each widening broadcast: the replication boundary.
    groups2: List[List[Instruction]] = []
    cur = []
    for m in members:
        if (
            cur
            and m.opcode == "broadcast"
            and m.operands
            and m.num_elements
            >= _BCAST_EXPAND_FACTOR * max(1, m.operands[0].num_elements)
        ):
            groups2.append(cur)
            cur = []
        cur.append(m)
    if cur:
        groups2.append(cur)
    if len(groups2) > 1 and [len(g) for g in groups2] != [len(g) for g in groups]:
        cands.append(("split_broadcast", groups2))

    cands.append(("nofuse", [[m] for m in members]))
    return cands


def _consistent_partition(
    groups: List[List[Instruction]], cfg: FusionConfig
) -> bool:
    """Every group must satisfy the injected SchdConsistent checker — the
    planner explores partitions, but the extension point still vetoes.
    Skipped when the checker is the scorer's own feasibility test, which
    the scoring pass already ran (and memoized)."""
    if cfg.scorer_covers_consistency:
        return True
    for g in groups:
        roots = FusedComputation(list(g), name="candidate").roots
        if not cfg.consistency(roots, g):
            return False
    return True


def _choose_partition(
    members: List[Instruction],
    scorer: Optional[FusionScorer],
    cfg: FusionConfig,
    stats: PlannerStats,
) -> Tuple[List[List[Instruction]], List[Optional[float]]]:
    """Pick the cheapest feasible partition; greedy is the floor.

    Returns (groups, per-group modeled costs).  When the greedy group cannot
    be scored (no satisfiable schedule under the scorer's limits — only
    reachable with a permissive external consistency checker), the greedy
    result is committed unscored, exactly as the greedy planner would.
    Single-member seeds are scored too, so the horizontal-merge pass can
    still pack them (single-op launch-bound towers are exactly the
    missed-merge pathology).
    """
    if scorer is None:
        return [members], [None]
    if len(members) <= 1:
        cost = scorer.fused_cost(members)
        stats.greedy_predicted_s += cost or 0.0
        return [members], [cost]
    cands = _candidate_partitions(members)
    stats.plans_explored += 1
    greedy_costs = scorer.partition_cost(cands[0][1])
    if greedy_costs is None:
        stats.plans_rejected += 1
        return [members], [None]
    best_name, best_groups, best_costs = "greedy", cands[0][1], greedy_costs
    best_total = sum(best_costs)
    for name, groups in cands[1:]:
        stats.plans_explored += 1
        costs = scorer.partition_cost(groups)
        if costs is None or not _consistent_partition(groups, cfg):
            stats.plans_rejected += 1
            continue
        total = sum(costs)
        if total < best_total:
            best_name, best_groups, best_costs = name, groups, costs
            best_total = total
    if best_name != "greedy":
        stats.splits_taken += 1
    stats.greedy_predicted_s += sum(greedy_costs)
    return best_groups, list(best_costs)


def _commit_fusion(
    g: List[Instruction],
    name: str,
    cost: Optional[float],
    scorer: Optional[FusionScorer],
) -> FusedComputation:
    """Build a committed FusedComputation, marking the phase structure when
    the scorer's verdict said the group lowers as a multi-phase stitch."""
    fc = FusedComputation(g, name=name, modeled_cost_s=cost)
    if scorer is not None and len(g) > 1:
        fc.stitch_phases = scorer.stitch_phases_for(g)
    return fc


def _sink_pack_groups(
    layer: List[Instruction],
    assigned: Set[int],
    claimed: Set[int],
    cfg: FusionConfig,
) -> List[List[Instruction]]:
    """Independent same-layer non-elementwise sinks with matching output
    (shape, dtype), e.g. N reduce towers or N reshape-terminated towers.
    ElementwiseFusion never groups these (its seeds are elementwise), so
    greedy commits one kernel per sink; the planner grows each sink's tower
    separately and then scores the union as ONE packed kernel against the
    per-tower floor (the stitch-across-break / pack candidate)."""
    by_key: Dict[tuple, List[Instruction]] = {}
    for instr in layer:
        if instr.id in assigned or instr.id in claimed:
            continue
        if instr.is_elementwise or instr.opcode in ("parameter", "constant", "iota"):
            continue
        if constant_like(instr) or not fusable_member(instr, cfg.fuse_dot):
            continue
        by_key.setdefault((tuple(instr.shape), str(instr.dtype)), []).append(instr)
    return [
        g
        for _, g in sorted(by_key.items(), key=lambda kv: str(kv[0]))
        if len(g) >= 2
    ]


def _choose_pack(
    towers: List[List[Instruction]],
    module: Module,
    scorer: FusionScorer,
    cfg: FusionConfig,
    stats: PlannerStats,
) -> Tuple[List[List[Instruction]], List[Optional[float]]]:
    """Commit a sink-pack group: either the union of all towers as ONE
    kernel, or each tower's own best partition (the greedy floor)."""
    groups: List[List[Instruction]] = []
    costs: List[Optional[float]] = []
    splits_before = stats.splits_taken
    for t in towers:
        g, c = _choose_partition(t, scorer, cfg, stats)
        groups.extend(g)
        costs.extend(c)
    if len(towers) < 2 or any(c is None for c in costs):
        return groups, costs
    union = set()
    for t in towers:
        union.update(t)
    if _group_cycle(union):
        return groups, costs
    packed = _topo_sorted(union, module)
    if len(packed) > cfg.max_fusion_ops:
        return groups, costs
    if (
        FusedComputation(packed, name="candidate").footprint_bytes()
        > cfg.ew_footprint_limit
    ):
        return groups, costs
    stats.plans_explored += 1
    cost = scorer.fused_cost(packed)
    if cost is None or not _consistent_partition([packed], cfg):
        stats.plans_rejected += 1
        return groups, costs
    if cost < sum(costs):
        stats.packs_taken += 1
        # the per-tower partitions (and any splits they took) are discarded
        stats.splits_taken = splits_before
        return [packed], [cost]
    return groups, costs


def _group_cycle(fused: Set[Instruction],
                 group_of: Optional[Dict[int, Tuple[Instruction, ...]]] = None) -> bool:
    """Would the member union reach itself through outside instructions
    (whole committed groups, ``_reaches``)?"""
    return _reaches([u for m in fused for u in m.users if u not in fused], fused, group_of)


def _groups_of(fusions: List["FusedComputation"]) -> Dict[int, Tuple[Instruction, ...]]:
    """Instruction id -> the members of its committed group."""
    out: Dict[int, Tuple[Instruction, ...]] = {}
    for f in fusions:
        members = tuple(f.members)
        out.update((m.id, members) for m in members)
    return out


def _cycle_through(fusions: List[FusedComputation],
                   standalone: List[Instruction]) -> Optional[int]:
    """The index of a fusion of more than one member on a cycle of the
    plan's units (its fusions and standalone instructions, as
    ``executor.order_units`` orders them; every such cycle has one, since
    the instructions alone are acyclic), or None where they are acyclic."""
    units: List[Tuple[Instruction, ...]] = [tuple(f.members) for f in fusions]
    units += [(i,) for i in standalone]
    unit_of = {m.id: u for u, members in enumerate(units) for m in members}
    succ = [sorted({unit_of[x.id] for m in members for x in m.users
                    if x.id in unit_of and unit_of[x.id] != u})
            for u, members in enumerate(units)]
    state = [0] * len(units)         # 0 unseen, 1 on the walk's path, 2 done
    for start in range(len(units)):
        if state[start]:
            continue
        path, stack = [start], [iter(succ[start])]
        state[start] = 1
        while stack:
            v = next(stack[-1], None)
            if v is None:
                state[path.pop()] = 2
                stack.pop()
            elif state[v] == 1:
                return next(u for u in path[path.index(v):] if len(units[u]) > 1)
            elif state[v] == 0:
                state[v] = 1
                path.append(v)
                stack.append(iter(succ[v]))
    return None


def _break_cycles(fusions: List[FusedComputation], standalone: List[Instruction],
                  scorer: Optional[FusionScorer]) -> List[FusedComputation]:
    """Split the fusions that close a cycle among the plan's units until
    none does.  Growth and merging walk paths over instructions, so a group
    can come to read, through another group, a value it writes itself: the
    other group's members need not depend on each other, but its kernel
    runs after every input of every member.  The fusion on a cycle splits
    in two: the members a path from it reaches (through whole groups) and
    those no such path reaches, the first part before the second; where
    every member is reached, into its members.  A part that has no
    schedule of its own splits into single members.  Each split adds a
    fusion, so the repair ends."""
    fusions = list(fusions)
    while True:
        k = _cycle_through(fusions, standalone)
        if k is None:
            return fusions
        f = fusions[k]
        members = set(f.members)
        group_of = _groups_of([g for g in fusions if g is not f])
        reached: Set[int] = set()
        stack = [u for m in f.members for u in m.users if u not in members]
        while stack:
            n = stack.pop()
            if n.id in reached:
                continue
            for g in group_of.get(n.id, (n,)):
                reached.add(g.id)
                stack.extend(u for u in g.users if u.id not in reached)
        parts = [p for p in ([m for m in f.members if m.id not in reached],
                             [m for m in f.members if m.id in reached]) if p]
        if len(parts) == 1:
            parts = [[m] for m in f.members]
        split: List[FusedComputation] = []
        for part in parts:
            cost = scorer.fused_cost(part) if scorer is not None else None
            pieces = [part] if len(part) == 1 or scorer is None or cost is not None else \
                [[m] for m in part]
            for piece in pieces:
                c = cost if len(pieces) == 1 else scorer.fused_cost(piece)
                split.append(_commit_fusion(piece, f"{f.name}_{len(split)}", c, scorer))
        fusions[k:k + 1] = split


def _merge_key(f: FusedComputation) -> tuple:
    return tuple(sorted((tuple(r.shape), str(r.dtype)) for r in f.roots))


def _horizontal_merge(
    fusions: List[FusedComputation],
    module: Module,
    scorer: FusionScorer,
    cfg: FusionConfig,
    stats: PlannerStats,
) -> List[FusedComputation]:
    """Pack independent fusions with matching root shapes into one kernel
    when the model says the saved launches beat the packing cost.

    Greedy never does this beyond same-layer ElementwiseFusion — missed
    horizontal merges are one of the two greedy pathologies the XLA fusion
    study (arXiv:2301.13062) documents.  Merges are gated on: known costs
    for both sides, the combined op count and footprint staying under the
    ElementwiseFusion limits, no group-level cycle through outside
    instructions (which also keeps dependent fusions on opposite sides of a
    library-call layer apart), a feasible merged schedule + memory plan, a
    strict modeled-latency improvement, and the injected SchdConsistent
    checker accepting the merged group.
    """
    changed = True
    while changed:
        changed = False
        by_key: Dict[tuple, List[int]] = {}
        for idx, f in enumerate(fusions):
            by_key.setdefault(_merge_key(f), []).append(idx)
        for idxs in by_key.values():
            if len(idxs) < 2:
                continue
            for ai in range(len(idxs)):
                a = fusions[idxs[ai]]
                if a is None or a.modeled_cost_s is None:
                    continue
                for bi in range(ai + 1, len(idxs)):
                    b = fusions[idxs[bi]]
                    if b is None or b.modeled_cost_s is None:
                        continue
                    if len(a.members) + len(b.members) > cfg.max_fusion_ops:
                        continue
                    if (
                        a.footprint_bytes() + b.footprint_bytes()
                        > cfg.ew_footprint_limit
                    ):
                        continue
                    union = set(a.members) | set(b.members)
                    if _group_cycle(union):
                        continue
                    merged_members = _topo_sorted(union, module)
                    stats.plans_explored += 1
                    cost = scorer.fused_cost(merged_members)
                    if cost is None:
                        stats.plans_rejected += 1
                        continue
                    if cost >= a.modeled_cost_s + b.modeled_cost_s:
                        continue
                    if not _consistent_partition([merged_members], cfg):
                        stats.plans_rejected += 1
                        continue
                    merged = _commit_fusion(
                        merged_members, a.name, cost, scorer
                    )
                    fusions[idxs[ai]] = merged
                    fusions[idxs[bi]] = None
                    a = merged
                    stats.merges_taken += 1
                    changed = True
        fusions = [f for f in fusions if f is not None]
    return fusions


# --------------------------------------------------------------------------
# The driver
# --------------------------------------------------------------------------


def deep_fuse(module: Module, cfg: Optional[FusionConfig] = None) -> FusionPlan:
    """The full fusion driver: Algorithm 1 growth (paper §3.2) plus, in
    ``planner="cost"`` mode, candidate-partition exploration and horizontal
    merging under the shared LatencyModel."""
    cfg = cfg or FusionConfig()
    scorer: Optional[FusionScorer] = None
    if cfg.planner == "cost":
        scorer = cfg.scorer or FusionScorer()
    stats = PlannerStats(mode=cfg.planner)

    span = span_lib.compute_spans(module)
    layer_map = span_lib.layers(module, span)
    max_span = max(span.values()) if span else 0
    lcs = span_lib.lc_spans(module, span)

    assigned: Set[int] = set()
    fusions: List[FusedComputation] = []
    forced_standalone: List[Instruction] = []
    greedy_fusion_count = 0      # kernels the pure-greedy plan would emit

    for root_span in range(0, max_span + 1):
        layer = layer_map.get(root_span, [])
        roof = span_lib.roof_for(root_span, lcs, max_span)

        # -- step 1: intra-layer ElementwiseFusion ------------------------
        seeds: List[List[Instruction]] = _elementwise_groups(layer, assigned, cfg)
        claimed = {i.id for g in seeds for i in g}
        # -- step 1.5: horizontal sink packs (cost planner + stitching) ---
        packs: List[List[Instruction]] = []
        if scorer is not None and cfg.enable_stitching:
            packs = _sink_pack_groups(layer, assigned, claimed, cfg)
            for g in packs:
                claimed.update(i.id for i in g)
        # -- step 2: every remaining fusable instruction seeds Algorithm 1
        for instr in layer:
            if instr.id in assigned or instr.id in claimed:
                continue
            if instr.opcode in ("parameter", "constant", "iota"):
                continue
            if constant_like(instr):
                continue  # folded at compile time; absorbed where consumed
            if not fusable_member(instr, cfg.fuse_dot):
                continue
            seeds.append([instr])

        for seed in seeds:
            if not cfg.consistency(seed, seed):
                # even the seed alone has no valid schedule — leave standalone
                for s in seed:
                    assigned.add(s.id)
                    forced_standalone.append(s)
                continue
            members = subgraph_fuse(
                seed, module, span, layer_map, roof, assigned, cfg
            )
            for m in members:
                assigned.add(m.id)
            greedy_fusion_count += 1
            groups, costs = _choose_partition(members, scorer, cfg, stats)
            for g, c in zip(groups, costs, strict=False):
                fusions.append(
                    _commit_fusion(g, f"f{len(fusions)}", c, scorer)
                )

        # -- step 3: sink-pack groups — grow each tower exactly as greedy
        # would (one seed per sink), then score the union as ONE kernel
        for group in packs:
            towers: List[List[Instruction]] = []
            for sink in group:
                if not cfg.consistency([sink], [sink]):
                    assigned.add(sink.id)
                    forced_standalone.append(sink)
                    continue
                t = subgraph_fuse(
                    [sink], module, span, layer_map, roof, assigned, cfg
                )
                for m in t:
                    assigned.add(m.id)
                towers.append(t)
                greedy_fusion_count += 1
            if not towers:
                continue
            groups, costs = _choose_pack(towers, module, scorer, cfg, stats)
            for g, c in zip(groups, costs, strict=False):
                fusions.append(
                    _commit_fusion(g, f"f{len(fusions)}", c, scorer)
                )

    # --- horizontal-merge post-pass (cost mode only) ---------------------
    if scorer is not None:
        fusions = _horizontal_merge(fusions, module, scorer, cfg, stats)

    # --- final pass: absorb constant-like producer chains (free ops) -----
    absorbed_fusions: List[FusedComputation] = []
    for f in fusions:
        members = set(f.members)
        stack = [o for m in f.members for o in m.operands]
        while stack:
            o = stack.pop()
            if o in members or o.id in assigned or o.opcode == "parameter":
                continue
            if o.opcode == "constant" and o.num_elements > 1:
                # Pallas kernel bodies can only inline SCALAR constants
                # (arrays would be captured closure constants, which
                # pallas_call rejects); array constants stay kernel inputs,
                # folded once at plan-build time into the buffer template.
                continue
            if constant_like(o):
                members.add(o)
                assigned.add(o.id)
                stack.extend(o.operands)
        scored_sig = None
        if (
            len(members) > len(f.members)
            and scorer is not None
            and scorer.measured is not None
        ):
            # Absorption changed the structure AFTER scoring: remember the
            # signature the scorer looked up, so the autotuner can file the
            # measurement under the key the next compile's scorer will ask
            # for.
            from .signature import fusion_signature  # local: import cycle

            scored_sig = fusion_signature(f)
        absorbed_fusions.append(
            FusedComputation(
                _topo_sorted(members, module),
                name=f.name,
                modeled_cost_s=f.modeled_cost_s,
                stitch_phases=f.stitch_phases,
                scored_signature=scored_sig,
            )
        )
    fusions = absorbed_fusions

    standalone = forced_standalone + [
        i
        for i in module.instructions
        if i.id not in assigned
        and i.opcode not in ("parameter", "constant")
        and not constant_like(i)
    ]
    # Drop trivial single-op "fusions" of free ops back to standalone
    real_fusions, extra = [], []
    for f in fusions:
        if len(f.members) == 1 and f.members[0].opcode in ("iota",):
            extra.append(f.members[0])
        else:
            real_fusions.append(f)
    real_fusions = _break_cycles(real_fusions, standalone + extra, scorer)
    plan = FusionPlan(real_fusions, standalone + extra, module, planner=stats)

    # --- planner accounting ----------------------------------------------
    # Collectives are charged (collective_op_time) but never counted as
    # kernels — they appear in neither mode's launch tally.
    shared_standalone = [
        s
        for s in plan.standalone
        if not s.is_library_call and not s.is_collective
    ]
    # Split/no-fuse singletons stay singleton *fusions* (never standalone),
    # so the standalone list is identical in both modes and greedy's kernel
    # count is one fusion per committed seed plus that shared remainder.
    stats.planned_kernels = plan.num_kernels
    stats.greedy_kernels = greedy_fusion_count + len(shared_standalone)
    stats.stitches_taken = sum(
        1 for f in plan.fusions if f.stitch_phases is not None
    )
    if scorer is not None:
        # a collective is priced only where the spec holds link numbers
        # (never on one card); it decides no plan either way
        shared_cost = sum(
            scorer.standalone_cost(s) for s in shared_standalone
        ) + sum(
            scorer.standalone_cost(s)
            for s in plan.standalone
            if s.is_collective and scorer.model.prices_collectives
        )
        stats.predicted_s = shared_cost + sum(
            f.modeled_cost_s
            for f in plan.fusions
            if f.modeled_cost_s is not None
        )
        stats.greedy_predicted_s += shared_cost
    return plan
