"""Schedule tuning — paper §4.3.

Single root: iterate the root's candidate schedules, keep the cheapest
satisfiable one (per the performance library).

Multiple roots: the paper's two-stage search — (1) per root, compute the set
of valid ``blocks`` values; intersect across roots; (2) iterate only over
schedule combinations whose blocks lie in the agreed set, accumulating per-op
times with best-so-far early exit.

Two paper optimizations are implemented: computationally trivial ops
(reshape/bitcast/broadcast, small transposes) are ignored during scoring —
they inline via thread composition with negligible cost but would otherwise
veto good schedules — and scoring aborts as soon as the running sum exceeds
the incumbent.

On a GPU (``lib.model.spec.is_gpu``) a schedule decides the grid the
generated kernel launches and which slots fit a block's shared memory, so
each candidate is scored as the kernel it lowers to: its memory plan under
``vmem_limit`` and ``LatencyModel.fusion_time`` over that plan (the grid's
share of the card, slots, recompute).  A candidate whose plan does not fit
is passed over while one that fits exists.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from .ir import Instruction
from .latency import is_trivial as _is_trivial  # shared convention (latency.py)
from .memory import MemoryInfeasible, MemoryPlan, plan_memory
from .perf_library import PerfLibrary
from .schedule import (
    REPLICATED,
    PhaseSolution,
    Sched,
    ScheduleSolution,
    StitchedSolution,
    Unsatisfiable,
    blocks_of,
    candidate_schedules,
    resolve_schedules,
)


@dataclass
class TunedPlan:
    solution: ScheduleSolution
    cost_s: float


def score(
    members: List[Instruction],
    solution: ScheduleSolution,
    lib: PerfLibrary,
    best_so_far: float = float("inf"),
    vmem_limit: Optional[int] = None,
) -> float:
    """Accumulated per-op time under the solution, with early exit; on a
    GPU the kernel's ``fusion_time`` (module docstring)."""
    if lib.model.spec.is_gpu:
        ids = {m.id for m in members}
        roots = [m for m in members if not m.users or any(u.id not in ids for u in m.users)]
        return _gpu_score(members, roots, solution, lib, vmem_limit)[0]
    total = 0.0
    for m in members:
        if _is_trivial(m):
            continue
        total += lib.lookup(m, solution.sched(m), solution.blocks)
        if total >= best_so_far:
            return float("inf")
    return lib.model.kernel_time(solution.blocks, total)


def _gpu_score(members, roots, solution, lib, vmem_limit):
    """(``fusion_time`` of the kernel ``solution`` lowers to, whether its
    memory plan fits ``vmem_limit``)."""
    mem = None
    fits = True
    if vmem_limit is not None:
        try:
            mem = plan_memory(members, roots, solution, vmem_limit, lib.model.spec)
        except MemoryInfeasible:
            fits = False
    return lib.model.fusion_time(members, roots, solution, mem), fits


class _Best:
    """The cheapest candidate so far; on a GPU, a candidate whose memory
    plan fits beats any that does not."""

    def __init__(self, members, roots, lib, vmem_limit):
        self.members, self.roots, self.lib, self.vmem_limit = members, roots, lib, vmem_limit
        self.gpu = lib.model.spec.is_gpu
        self.plan: Optional[TunedPlan] = None
        self.fits = False

    def offer(self, sol: ScheduleSolution) -> None:
        if not self.gpu:
            c = score(self.members, sol, self.lib,
                      self.plan.cost_s if self.plan else float("inf"))
            if self.plan is None or c < self.plan.cost_s:
                self.plan = TunedPlan(sol, c)
            return
        c, fits = _gpu_score(self.members, self.roots, sol, self.lib, self.vmem_limit)
        if self.plan is None or (fits, -c) > (self.fits, -self.plan.cost_s):
            self.plan, self.fits = TunedPlan(sol, c), fits


def tune(
    members: List[Instruction],
    roots: List[Instruction],
    lib: PerfLibrary,
    max_blocks: int = 1 << 16,
    replicate_limit: int = 512 * 1024,
    max_combos: int = 64,
    vmem_limit: Optional[int] = None,
) -> Optional[TunedPlan]:
    """Find the cheapest satisfiable schedule for a fused computation
    (on a GPU, among those whose memory plan fits ``vmem_limit``)."""
    best = _Best(members, roots, lib, vmem_limit)
    for sol in _solutions(members, roots, max_blocks, replicate_limit, max_combos,
                          lib.model.spec):
        best.offer(sol)
    return best.plan


def _solutions(members, roots, max_blocks, replicate_limit, max_combos, spec=None):
    """Each satisfiable schedule ``tune`` weighs, in the order it weighs
    them."""
    if len(roots) == 1:
        root = roots[0]
        for sched in candidate_schedules(root.shape, max_blocks):
            try:
                yield resolve_schedules(members, roots, {root.id: sched}, replicate_limit, spec)
            except Unsatisfiable:
                continue
        return
    # ---- stage 1: intersect valid blocks sets across roots (paper §4.3) --
    per_root: List[Dict[int, List[Sched]]] = []
    for r in roots:
        by_blocks: Dict[int, List[Sched]] = {}
        for sched in candidate_schedules(r.shape, max_blocks):
            by_blocks.setdefault(blocks_of(r.shape, sched), []).append(sched)
        per_root.append(by_blocks)
    agreed = set(per_root[0])
    for bb in per_root[1:]:
        agreed &= set(bb)

    # ---- stage 2: iterate schedules in the agreed blocks set -------------
    for b in sorted(agreed, reverse=True):  # prefer more parallelism first
        combos = itertools.islice(
            itertools.product(*[bb[b] for bb in per_root]), max_combos
        )
        for combo in combos:
            rs = {r.id: s for r, s in zip(roots, combo, strict=False)}
            try:
                yield resolve_schedules(members, roots, rs, replicate_limit, spec)
            except Unsatisfiable:
                continue


def tune_kernel(
    members: List[Instruction],
    roots: List[Instruction],
    lib: PerfLibrary,
    max_blocks: int,
    replicate_limit: int,
    vmem_limit: int,
) -> Optional[Tuple[TunedPlan, MemoryPlan]]:
    """The cheapest schedule whose memory plan fits ``vmem_limit``, with
    that plan, or None where none fits (the GPU scorer's feasibility)."""
    tuned = tune(members, roots, lib, max_blocks=max_blocks,
                 replicate_limit=replicate_limit, vmem_limit=vmem_limit)
    if tuned is None:
        return None
    try:
        return tuned, plan_memory(members, roots, tuned.solution, vmem_limit, lib.model.spec)
    except MemoryInfeasible:
        return None


def kernel_fits(
    members: List[Instruction],
    roots: List[Instruction],
    lib: PerfLibrary,
    max_blocks: int,
    replicate_limit: int,
    vmem_limit: int,
) -> bool:
    """Whether ``tune_kernel`` finds a plan (on a GPU): whether a schedule
    it weighs has a memory plan that fits ``vmem_limit``, asked of each in
    turn up to the first that does, with no cost computed."""
    spec = lib.model.spec
    for sol in _solutions(members, roots, max_blocks, replicate_limit, 64, spec):
        try:
            plan_memory(members, roots, sol, vmem_limit, spec)
        except MemoryInfeasible:
            continue
        return True
    return False


def tune_phases(
    stitched: StitchedSolution,
    lib: PerfLibrary,
    max_blocks: int,
    replicate_limit: int,
    vmem_limit: Optional[int] = None,
) -> StitchedSolution:
    """``stitched`` with each phase's schedule tuned (at most ``max_blocks``
    plan blocks; a phase with no schedule keeps the one it has)."""
    phases = []
    for p in stitched.phases:
        tuned = tune(p.members, p.roots, lib, max_blocks=max_blocks,
                     replicate_limit=replicate_limit, vmem_limit=vmem_limit)
        phases.append(p if tuned is None else PhaseSolution(p.members, p.roots, tuned.solution))
    return StitchedSolution(phases, list(stitched.interfaces))
