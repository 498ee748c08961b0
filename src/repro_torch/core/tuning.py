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
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Dict, List, Optional

from .ir import Instruction
from .latency import is_trivial as _is_trivial  # shared convention (latency.py)
from .perf_library import PerfLibrary
from .schedule import (
    REPLICATED,
    Sched,
    ScheduleSolution,
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
) -> float:
    """Accumulated per-op time under the solution, with early exit."""
    total = 0.0
    for m in members:
        if _is_trivial(m):
            continue
        total += lib.lookup(m, solution.sched(m), solution.blocks)
        if total >= best_so_far:
            return float("inf")
    return lib.model.kernel_time(solution.blocks, total)


def tune(
    members: List[Instruction],
    roots: List[Instruction],
    lib: PerfLibrary,
    max_blocks: int = 1 << 16,
    replicate_limit: int = 512 * 1024,
    max_combos: int = 64,
) -> Optional[TunedPlan]:
    """Find the cheapest satisfiable schedule for a fused computation."""
    if len(roots) == 1:
        return _tune_single(members, roots, lib, max_blocks, replicate_limit)
    return _tune_multi(
        members, roots, lib, max_blocks, replicate_limit, max_combos
    )


def _tune_single(members, roots, lib, max_blocks, replicate_limit):
    root = roots[0]
    best: Optional[TunedPlan] = None
    for sched in candidate_schedules(root.shape, max_blocks):
        try:
            sol = resolve_schedules(
                members, roots, {root.id: sched}, replicate_limit
            )
        except Unsatisfiable:
            continue
        c = score(members, sol, lib, best.cost_s if best else float("inf"))
        if best is None or c < best.cost_s:
            best = TunedPlan(sol, c)
    return best


def _tune_multi(members, roots, lib, max_blocks, replicate_limit, max_combos):
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
    if not agreed:
        return None

    # ---- stage 2: iterate schedules in the agreed blocks set -------------
    best: Optional[TunedPlan] = None
    for b in sorted(agreed, reverse=True):  # prefer more parallelism first
        combos = itertools.islice(
            itertools.product(*[bb[b] for bb in per_root]), max_combos
        )
        for combo in combos:
            rs = {r.id: s for r, s in zip(roots, combo, strict=False)}
            try:
                sol = resolve_schedules(members, roots, rs, replicate_limit)
            except Unsatisfiable:
                continue
            c = score(members, sol, lib, best.cost_s if best else float("inf"))
            if best is None or c < best.cost_s:
                best = TunedPlan(sol, c)
    return best
