"""Schedule specification + constraint propagation — paper §4.1/§4.2.

A schedule for one instruction is ``(split_dim, sword, sched_type)`` defined
on its *output* shape: the work space is split into ``blocks`` chunks, one
per grid program (the CTA analogue on TPU).

  Row    : blocks = prod(shape[:split]) * sword.  A block owns a
           ``1/sword`` slice of the split dim and the **full minor dims**
           (everything right of the split).  Row chunks are contiguous in
           row-major order — the layout-friendly direction on TPU.
  Column : blocks = sword * prod(shape[split+1:]).  A block owns the full
           **major dims** and fixed minor coordinates.

Propagation maps a schedule on an instruction's output to schedules on its
operands by the op-specific rules of Table 1.  Two extensions the codegen
needs that the paper leaves implicit:

  * ``Replicated`` — the degenerate schedule where every block sees/computes
    the full tensor (broadcast operands, tiny reduce results).  Bounded by
    ``replicate_limit`` so a fused kernel can never demand an unbounded
    VMEM-resident operand.
  * alignment — all *chunked* instructions in a fusion must agree on the
    launch ``blocks``; propagation fails (or falls back to Replicated) when
    an op's own blocks formula cannot match the launch grid.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Dict, List, Optional, Sequence, Tuple


from .ir import COLLECTIVE_OPCODES, Instruction, _prod, sliced_dims

ROW = "Row"
COLUMN = "Column"


@dataclass(frozen=True)
class Sched:
    """Schedule of one instruction's output space."""

    kind: str = "chunked"       # "chunked" | "replicated"
    split_dim: int = 0
    sword: int = 1
    sched_type: str = ROW

    @staticmethod
    def replicated() -> "Sched":
        return Sched(kind="replicated")

    def __repr__(self):
        if self.kind == "replicated":
            return "Sched(repl)"
        return f"Sched({self.sched_type}, split={self.split_dim}, sword={self.sword})"


REPLICATED = Sched.replicated()


def blocks_of(shape: Tuple[int, ...], sched: Sched) -> int:
    if sched.kind == "replicated":
        return 1
    s, w = sched.split_dim, sched.sword
    if sched.sched_type == ROW:
        return _prod(shape[:s]) * w
    return w * _prod(shape[s + 1:])


def chunk_shape(shape: Tuple[int, ...], sched: Sched) -> Tuple[int, ...]:
    if sched.kind == "replicated":
        return tuple(shape)
    s, w = sched.split_dim, sched.sword
    n = len(shape)
    if sched.sched_type == ROW:
        return (1,) * s + (shape[s] // w,) + tuple(shape[s + 1:])
    return tuple(shape[:s]) + (shape[s] // w,) + (1,) * (n - s - 1)


def block_index(shape: Tuple[int, ...], sched: Sched, b):
    """Block-unit multi-index for grid step ``b`` (Pallas index_map body).

    Works with python ints and traced values alike (uses //, %).
    """
    n = len(shape)
    if sched.kind == "replicated":
        return (0,) * n
    s, w = sched.split_dim, sched.sword
    idx = [0] * n
    if sched.sched_type == ROW:
        sub = b % w
        major = b // w
        idx[s] = sub
        for d in range(s - 1, -1, -1):
            idx[d] = major % shape[d]
            major = major // shape[d]
    else:
        minorprod = _prod(shape[s + 1:])
        sub = b // minorprod
        minor = b % minorprod
        idx[s] = sub
        for d in range(n - 1, s, -1):
            idx[d] = minor % shape[d]
            minor = minor // shape[d]
    return tuple(idx)


def _divisors(n: int, cap: int = 24) -> List[int]:
    ds = [d for d in range(1, int(n ** 0.5) + 1) if n % d == 0]
    ds = sorted(set(ds + [n // d for d in ds]))
    if len(ds) > cap:
        # keep a spread: ends + powers-of-two-ish interior
        keep = {ds[0], ds[-1]}
        for d in ds:
            if d & (d - 1) == 0:  # power of two divisor
                keep.add(d)
        ds = sorted(keep)[:cap]
    return ds


def candidate_schedules(shape: Tuple[int, ...], max_blocks: int = 1 << 16) -> List[Sched]:
    """The (small) schedule space of one output shape — paper §4.1."""
    return list(_candidates(tuple(shape), max_blocks))


@lru_cache(maxsize=4096)
def _candidates(shape: Tuple[int, ...], max_blocks: int) -> Tuple[Sched, ...]:
    """``candidate_schedules``, once a (shape, max_blocks): the planner asks
    for the same shapes over and over."""
    if not shape:
        return (REPLICATED,)
    out, seen = [], set()
    for s in range(len(shape)):
        for w in _divisors(shape[s]):
            for t in (ROW, COLUMN):
                sched = Sched("chunked", s, w, t)
                b = blocks_of(shape, sched)
                if b > max_blocks:
                    continue
                key = (b, chunk_shape(shape, sched))
                if key in seen:
                    continue
                seen.add(key)
                out.append(sched)
    return tuple(out)


# --------------------------------------------------------------------------
# Table-1 propagation rules
# --------------------------------------------------------------------------


class Unsatisfiable(Exception):
    pass


def _map_reduce_out_to_in(split_out: int, reduce_dims: Tuple[int, ...]) -> int:
    """Map an output dim index of a reduce to the input dim index."""
    rd = set(reduce_dims)
    kept = [i for i in range(max(rd) + split_out + 2) if i not in rd]
    return kept[split_out]


def dot_row_split(spec) -> bool:
    """Whether a plan for ``spec`` (a ``latency.DeviceSpec``, or None: the
    reference's) may split a dot's output at its row dimension: only on a
    GPU, where a block reads the rhs whole from the L2."""
    return spec is not None and spec.is_gpu


#: opcodes that compute each element from their operands' elements alone,
#: element by element or through an index map (``index_values``)
_INDEX_MAPS = frozenset({"reshape", "broadcast", "transpose", "elementwise", "select"})


def index_values(members: Sequence[Instruction]) -> set:
    """Ids of the members whose value is computed from indices alone: an
    ``iota`` or a ``constant``, or a reshape, broadcast, transpose,
    elementwise or select whose operands are all such members.  No
    parameter and no fusion input lies under one.  ``members`` is in
    topological order."""
    out: set = set()
    for m in members:
        if m.opcode in ("iota", "constant") or (
                m.opcode in _INDEX_MAPS and all(o.id in out for o in m.operands)):
            out.add(m.id)
    return out


def is_row_split_dot(instr: Instruction, sched: Sched) -> bool:
    """A batched dot split at its output's row dimension (``dot_row_split``)."""
    return (instr.opcode == "dot" and instr.ndim > 2 and sched.kind == "chunked"
            and sched.sched_type == ROW and sched.split_dim == instr.ndim - 2)


def propagate(instr: Instruction, sched: Sched, row_split: bool = False) -> List[Sched]:
    """Given ``sched`` on ``instr``'s output, derive operand schedules.

    Returns one Sched per operand.  Raises Unsatisfiable when Table 1 has no
    rule that passes.  ``row_split`` adds a rule Table 1 has not: a batched
    dot split at its output's row dimension, its lhs split so and its rhs
    read whole (``dot_row_split``; the planner offers it under a GPU spec,
    and what reads a plan takes it wherever the plan has it).  A 2-D dot
    keeps the reference's rule, so it stays the matmul library's: each of
    its blocks would read the whole weight.
    """
    if sched.kind == "replicated":
        return [REPLICATED] * len(instr.operands)

    op = instr.opcode
    a = instr.attrs
    s, w, t = sched.split_dim, sched.sword, sched.sched_type

    if op in ("elementwise", "select"):
        # Pass Row, Column (Table 1) — scalar/mismatched operands replicate.
        out = []
        for o in instr.operands:
            out.append(sched if tuple(o.shape) == tuple(instr.shape) else REPLICATED)
        return out

    if op == "transpose":
        perm = a["perm"]
        moved = [i for i in range(len(perm)) if perm[i] != i]
        if not moved:
            return [sched]
        if t == ROW and s < min(moved):
            return [sched]       # transpose happens fully inside the block
        if t == COLUMN and s > max(moved):
            return [sched]
        raise Unsatisfiable(f"transpose {perm} split={s} {t}")

    if op in ("slice", "cumsum"):
        # each holds the dims it reads across whole in a block, as a reduce
        # holds its reduced dims: a slice its sliced dims, a running sum
        # its summed dim; every other dim maps one to one
        cut = sliced_dims(instr) if op == "slice" else (a["dim"],)
        if not cut or (t == ROW and s < min(cut)) or (t == COLUMN and s > max(cut)):
            return [sched]
        raise Unsatisfiable(f"{op} across dims {cut} split={s} {t}")

    if op == "reduce":
        rdims = tuple(a["dims"])
        s_in = _map_reduce_out_to_in(s, rdims)
        in_shape = instr.operands[0].shape
        if t == ROW and s_in < min(rdims):
            return [Sched("chunked", s_in, w, ROW)]
        if t == COLUMN and s_in > max(rdims):
            return [Sched("chunked", s_in, w, COLUMN)]
        raise Unsatisfiable(f"reduce dims={rdims} split_out={s} {t}")

    if op == "dot":
        n = instr.ndim
        if t == ROW and s < n - 2:
            lhs, rhs = instr.operands
            return [Sched("chunked", s, w, ROW), Sched("chunked", s, w, ROW)]
        if row_split and t == ROW and s == n - 2 and n > 2:
            return [Sched("chunked", s, w, ROW), REPLICATED]
        raise Unsatisfiable(f"dot split={s} {t}")

    if op in ("reshape", "bitcast"):
        in_shape = tuple(instr.operands[0].shape)
        out_shape = tuple(instr.shape)
        if t == ROW:
            # Row chunks are contiguous row-major runs; reshape preserves
            # linearization.  Find (s', w') with the same run length.
            run = _prod(out_shape[s + 1:]) * (out_shape[s] // w)
            for s2 in range(len(in_shape)):
                suffix = _prod(in_shape[s2 + 1:])
                if run % suffix == 0:
                    c = run // suffix
                    if c >= 1 and in_shape[s2] % c == 0 and c <= in_shape[s2]:
                        return [Sched("chunked", s2, in_shape[s2] // c, ROW)]
            raise Unsatisfiable(f"reshape {in_shape}->{out_shape} run={run}")
        # Column: only safe when the reshape leaves the split dim and all
        # minor dims untouched.
        tail = out_shape[s:]
        for s2 in range(len(in_shape)):
            if tuple(in_shape[s2:]) == tail:
                return [Sched("chunked", s2, w, COLUMN)]
        raise Unsatisfiable(f"reshape-col {in_shape}->{out_shape}")

    if op == "broadcast":
        dims = tuple(a["dims"])
        opnd = instr.operands[0]
        if s in dims:
            i = dims.index(s)
            # the operand's block index equals the output's only where the
            # dims the index is spread over map one to one: under Row the
            # operand's major dims must be the output's innermost major
            # dims, under Column its minor dims the output's minor dims;
            # otherwise the operand is read whole and each block slices it
            # by its own output window (``codegen._emit_instr``)
            if t == ROW:
                spread = dims[:i] == tuple(range(s - i, s))
                same = all(opnd.shape[j] == instr.shape[dims[j]] for j in range(i))
            else:
                spread = dims[i + 1:] == tuple(range(s + 1, instr.ndim))
                same = all(opnd.shape[j] == instr.shape[dims[j]]
                           for j in range(i + 1, len(dims)))
            if opnd.shape[i] == instr.shape[s] and spread and same:
                return [Sched("chunked", i, w, t)]
        return [REPLICATED]

    if op == "concat":
        d = a["dim"]
        if (t == ROW and s < d) or (t == COLUMN and s > d):
            return [sched] * len(instr.operands)
        raise Unsatisfiable(f"concat dim={d} split={s} {t}")

    if op == "gather":
        idx = instr.operands[1]
        if t == ROW and s < idx.ndim:
            return [REPLICATED, Sched("chunked", s, w, ROW)]
        raise Unsatisfiable(f"gather split={s} {t}")

    if op in ("iota", "constant", "parameter"):
        return []

    if op in COLLECTIVE_OPCODES:
        # Collectives synchronize the whole mesh — they can never live
        # inside a kernel, so no block schedule exists for them.  The fusion
        # pass keeps them out (not in FUSABLE_OPCODES); this guard makes a
        # planner bug loud instead of a silent mis-schedule.
        raise Unsatisfiable(f"{op} is a collective: schedule break, not fusable")

    raise Unsatisfiable(f"no propagation rule for {op}")


# --------------------------------------------------------------------------
# Whole-fusion schedule resolution (root -> leaves)
# --------------------------------------------------------------------------


@dataclass
class ScheduleSolution:
    """A satisfiable schedule assignment for a fused computation."""

    blocks: int
    assignment: Dict[int, Sched]          # instr id -> Sched (members + inputs)
    root_scheds: Dict[int, Sched]
    # replicated members computed from indices alone that the solution let
    # past ``replicate_limit`` (``resolve_schedules``): each is recomputed
    # where it is read and takes no slot
    index_values: frozenset = frozenset()

    def sched(self, instr: Instruction) -> Sched:
        return self.assignment[instr.id]


def resolve_schedules(
    members: List[Instruction],
    roots: List[Instruction],
    root_scheds: Dict[int, Sched],
    replicate_limit: int = 512 * 1024,
    spec=None,
) -> ScheduleSolution:
    """Back-propagate root schedules through the fusion (paper §4.2).

    ``members`` must be topologically ordered.  All chunked instructions are
    checked to agree on the launch ``blocks``.  Conflicting requirements fall
    back to Replicated when the tensor fits ``replicate_limit``.  Under a
    GPU ``spec`` a dot may be split at its output's rows
    (``dot_row_split``); its rhs, and what that is computed from, may then
    be replicated up to the whole rhs the L2 was measured to serve
    (``spec.l2_read_limit``), which every block reads it from.  Under a
    GPU ``spec`` a member computed from indices alone (``index_values``),
    other than a root, is not held to ``replicate_limit`` at all: a
    generated kernel never stages it, but computes each element it reads
    from that element's index.
    """
    rows = dot_row_split(spec)
    l2_limit = max(replicate_limit, spec.l2_read_limit) if rows else replicate_limit
    read_from_l2: set = set()   # a row-split dot's rhs and its producers
    computed = index_values(members) - {r.id for r in roots} if rows else set()
    let_past: set = set()       # members of ``computed`` past the limit
    member_ids = {m.id for m in members}
    launch_blocks = None
    for r in roots:
        b = blocks_of(r.shape, root_scheds[r.id])
        if launch_blocks is None:
            launch_blocks = b
        elif launch_blocks != b:
            raise Unsatisfiable(
                f"root blocks disagree: {launch_blocks} vs {b} ({r.name})"
            )
    assignment: Dict[int, Sched] = {}
    visited: set = set()        # the members the current sweep has propagated from
    late = [False]              # one of them changed after its propagation

    def assign(instr: Instruction, sched: Sched) -> bool:
        """Record ``sched`` for ``instr``; True if the assignment changed.

        Assignments are monotone: an instruction may only move from
        unassigned -> chunked -> replicated, so a fixpoint exists.
        """
        if sched.kind == "chunked" and blocks_of(instr.shape, sched) != launch_blocks:
            sched = REPLICATED  # cannot align with the launch grid
        prev = assignment.get(instr.id)
        if prev is not None and prev != sched:
            sched = REPLICATED  # conflicting requirements -> whole tensor
        limit = l2_limit if instr.id in read_from_l2 else replicate_limit
        if sched.kind == "replicated" and instr.bytesize > limit:
            if instr.id in computed:
                let_past.add(instr.id)
            else:
                raise Unsatisfiable(
                    f"{instr.name}: replicated {instr.bytesize}B > limit"
                )
        if prev == sched:
            return False
        assignment[instr.id] = sched
        late[0] |= instr.id in visited
        return True

    for r in roots:
        assign(r, root_scheds[r.id])

    # Reverse-topo sweeps to fixpoint (downgrades to Replicated can cascade;
    # monotonicity bounds the iteration count).  A sweep that changed no
    # member after propagating from it has reached the fixpoint: every
    # propagation read its member's final schedule, and what each operand
    # then got is its users' schedule or replicated, so the next sweep and
    # the check below would find nothing (in topological order, one sweep).
    for _ in range(len(members) + 1):
        changed = False
        visited.clear()
        late[0] = False
        for instr in reversed(members):
            if instr.id not in assignment:
                # member never reached from a root yet — replicate
                changed |= assign(instr, REPLICATED)
            sched = assignment[instr.id]
            if rows and is_row_split_dot(instr, sched):
                read_from_l2.add(instr.operands[1].id)
            elif instr.id in read_from_l2 and sched.kind == "replicated":
                read_from_l2.update(o.id for o in instr.operands)
            for o, osched in zip(instr.operands, propagate(instr, sched, rows), strict=False):
                changed |= assign(o, osched)
            visited.add(instr.id)
        if not changed or not late[0]:
            break

    # Final soundness check: every member's operands must be readable under
    # the member's schedule (equal or replicated).
    for instr in members if late[0] else ():
        sched = assignment[instr.id]
        for o, osched in zip(instr.operands, propagate(instr, sched, rows), strict=False):
            got = assignment[o.id]
            if got != osched and got.kind != "replicated":
                raise Unsatisfiable(
                    f"{instr.name}: operand {o.name} has {got}, needs {osched}"
                )

    return ScheduleSolution(launch_blocks, assignment, dict(root_scheds), frozenset(let_past))


def any_satisfiable(
    members: List[Instruction],
    roots: List[Instruction],
    candidates: Optional[List[Sched]] = None,
    replicate_limit: int = 512 * 1024,
    max_blocks: int = 1 << 16,
    spec=None,
) -> Optional[ScheduleSolution]:
    """Cheap existence check used by SchdConsistent during fusion."""
    cands = candidates or _candidates(tuple(roots[0].shape), max_blocks)
    # each other root shape's first schedule of a given blocks count
    first: Dict[Tuple[int, ...], Dict[int, Sched]] = {}
    for r in roots:
        shape = tuple(r.shape)
        if shape != tuple(roots[0].shape) and shape not in first:
            by_blocks: Dict[int, Sched] = {}
            for c in _candidates(shape, max_blocks):
                by_blocks.setdefault(blocks_of(shape, c), c)
            first[shape] = by_blocks
    for sched in cands:
        try:
            b = blocks_of(roots[0].shape, sched)
            rs = {}
            ok = True
            for r in roots:
                if tuple(r.shape) == tuple(roots[0].shape):
                    rs[r.id] = sched
                else:
                    # a sched for r with the same blocks
                    alt = first[tuple(r.shape)].get(b)
                    if alt is None:
                        ok = False
                        break
                    rs[r.id] = alt
            if not ok:
                continue
            return resolve_schedules(members, roots, rs, replicate_limit, spec)
        except Unsatisfiable:
            continue
    return None


# --------------------------------------------------------------------------
# Multi-phase stitching across schedule breaks (follow-up work,
# arXiv:1911.11576 / 2009.10924): when no SINGLE block schedule covers a
# group (reduce -> re-tiled broadcast, full transposes past the replicate
# limit), the group may still lower to ONE kernel as a sequence of
# schedule-consistent *phases*.  Every value crossing a phase boundary (an
# "interface" tensor) is materialized WHOLE in a VMEM staging buffer by the
# producer phase and re-tiled by the consumer phase's own schedule.
# --------------------------------------------------------------------------

CONSISTENT = "consistent"      # one schedule covers the whole group
STITCHABLE = "stitchable"      # multi-phase lowering through staged buffers
INFEASIBLE = "infeasible"      # some member has no schedule at all


@dataclass
class PhaseSolution:
    """One schedule-consistent phase of a stitched kernel."""

    members: List[Instruction]           # topological order
    roots: List[Instruction]             # values leaving the phase
    solution: ScheduleSolution

    @property
    def blocks(self) -> int:
        return self.solution.blocks


@dataclass
class StitchedSolution:
    """A feasible multi-phase schedule assignment for one fused group.

    ``interfaces`` are the group-interior values produced in one phase and
    consumed in a later one: they are staged FULLY (untiled) in VMEM, so the
    consumer phase can re-tile them under an arbitrary sub-schedule.
    """

    phases: List[PhaseSolution]
    interfaces: List[Instruction]

    @property
    def num_phases(self) -> int:
        return len(self.phases)

    @property
    def blocks(self) -> int:
        """Total sequential grid steps across all phase loops."""
        return sum(p.blocks for p in self.phases)

    @property
    def phase_sizes(self) -> Tuple[int, ...]:
        return tuple(len(p.members) for p in self.phases)

    @property
    def interface_bytes(self) -> int:
        return sum(i.bytesize for i in self.interfaces)

    def phase_of(self, instr: Instruction) -> int:
        for k, p in enumerate(self.phases):
            if any(m.id == instr.id for m in p.members):
                return k
        raise KeyError(instr.name)


@dataclass
class StitchVerdict:
    """The three-way result of ``stitchable`` — replaces the boolean
    SchdConsistent veto.  Exactly one payload is set per verdict."""

    verdict: str                                   # CONSISTENT | STITCHABLE | INFEASIBLE
    solution: Optional[ScheduleSolution] = None    # CONSISTENT
    stitched: Optional[StitchedSolution] = None    # STITCHABLE

    def __bool__(self) -> bool:
        return self.verdict != INFEASIBLE


def _phase_roots(
    phase_members: List[Instruction], phase_ids: set
) -> List[Instruction]:
    """Values leaving a phase: used by a later phase of the same group or by
    anything outside the group entirely."""
    out = []
    for m in phase_members:
        if not m.users or any(u.id not in phase_ids for u in m.users):
            out.append(m)
    return out


def _phase_solution(
    phase_members: List[Instruction],
    replicate_limit: int,
    max_blocks: int,
    stitch_replicate_limit: int,
    spec=None,
) -> Tuple[Optional[ScheduleSolution], int]:
    """A schedule for one phase plus its quality *tier*.

    Tier 0: chunked under the normal replicate limit (the same solution a
    consistent fusion would get).  Tier 1: needs the relaxed stitching limit
    (the phase's working set lives in VMEM staging anyway, so replication is
    bounded by the stitched memory plan, not this check).  Tier 2: the
    degenerate fully-replicated single-block phase ``candidate_schedules``
    never proposes — ops like full transposes have NO chunked schedule, and
    whole-tensor execution inside a staged phase is exactly what stitching
    buys.  The phase partitioner cuts rather than letting growth DOWNGRADE
    an existing phase's tier.
    """
    phase_ids = {m.id for m in phase_members}
    roots = _phase_roots(phase_members, phase_ids)
    if not roots:
        return None, 99
    sol = any_satisfiable(
        phase_members, roots,
        replicate_limit=replicate_limit, max_blocks=max_blocks, spec=spec,
    )
    if sol is not None:
        return sol, 0
    lim = max(stitch_replicate_limit, replicate_limit)
    sol = any_satisfiable(
        phase_members, roots, replicate_limit=lim, max_blocks=max_blocks, spec=spec
    )
    if sol is not None:
        return sol, 1
    try:
        return (
            resolve_schedules(
                phase_members, roots, {r.id: REPLICATED for r in roots}, lim, spec
            ),
            2,
        )
    except Unsatisfiable:
        return None, 99


def resolve_stitched(
    members: List[Instruction],
    roots: List[Instruction],
    replicate_limit: int = 512 * 1024,
    max_blocks: int = 1 << 16,
    stitch_replicate_limit: int = 4 * 1024 * 1024,
    stitch_max_blocks: int = 64,
    max_phases: int = 8,
    spec=None,
) -> Optional[StitchedSolution]:
    """Partition ``members`` (topologically ordered) into schedule-consistent
    phases at schedule breaks, greedily: grow the current phase one member at
    a time and cut exactly where ``any_satisfiable`` stops holding.  Phase
    grids are capped at ``stitch_max_blocks`` because each phase lowers as a
    sequential loop over its sub-schedule inside one kernel.

    Returns None when some member has no schedule even in a phase of its own
    (or the phase count explodes) — the group is then truly infeasible.
    """
    group_ids = {m.id for m in members}
    blocks_cap = min(max_blocks, stitch_max_blocks)
    phases: List[PhaseSolution] = []
    cur: List[Instruction] = []
    cur_sol: Optional[ScheduleSolution] = None
    cur_tier = 99
    for m in members:
        trial = cur + [m]
        sol, tier = _phase_solution(
            trial, replicate_limit, blocks_cap, stitch_replicate_limit, spec
        )
        if sol is not None and (not cur or tier <= cur_tier):
            cur, cur_sol, cur_tier = trial, sol, tier
            continue
        if not cur:
            return None                      # m alone has no schedule
        phase_ids = {i.id for i in cur}
        phases.append(
            PhaseSolution(cur, _phase_roots(cur, phase_ids), cur_sol)
        )
        if len(phases) >= max_phases:
            return None
        cur = [m]
        cur_sol, cur_tier = _phase_solution(
            cur, replicate_limit, blocks_cap, stitch_replicate_limit, spec
        )
        if cur_sol is None:
            return None
    if cur:
        phase_ids = {i.id for i in cur}
        phases.append(
            PhaseSolution(cur, _phase_roots(cur, phase_ids), cur_sol)
        )
    # interface tensors: produced in one phase, consumed in a later one
    phase_of: Dict[int, int] = {}
    for k, p in enumerate(phases):
        for i in p.members:
            phase_of[i.id] = k
    interfaces: List[Instruction] = []
    for p in phases:
        for i in p.members:
            if any(
                u.id in group_ids and phase_of[u.id] > phase_of[i.id]
                for u in i.users
            ):
                interfaces.append(i)
    return StitchedSolution(phases, interfaces)


def stitchable(
    roots: List[Instruction],
    members: List[Instruction],
    replicate_limit: int = 512 * 1024,
    max_blocks: int = 1 << 16,
    stitch_replicate_limit: int = 4 * 1024 * 1024,
    stitch_max_blocks: int = 64,
    allow_stitch: bool = True,
    spec=None,
) -> StitchVerdict:
    """Three-way schedule-consistency verdict for a tentative fusion group.

    CONSISTENT: one block schedule covers every member (the paper's
    SchdConsistent).  STITCHABLE: no single schedule exists, but the group
    partitions into consistent phases stitched through staged VMEM buffers.
    INFEASIBLE: neither — the fusion pass must not take this enlargement.

    Cost note: an INFEASIBLE verdict pays the full phase-partition attempt
    (O(members) ``any_satisfiable`` solves) on top of the consistent check;
    callers that probe many enlargements should memoize by member set, as
    ``FusionScorer.verdict`` does.
    """
    sol = any_satisfiable(
        members, roots, replicate_limit=replicate_limit, max_blocks=max_blocks, spec=spec
    )
    if sol is not None:
        return StitchVerdict(CONSISTENT, solution=sol)
    if not allow_stitch:
        return StitchVerdict(INFEASIBLE)
    st = resolve_stitched(
        members, roots,
        replicate_limit=replicate_limit,
        max_blocks=max_blocks,
        stitch_replicate_limit=stitch_replicate_limit,
        stitch_max_blocks=stitch_max_blocks,
        spec=spec,
    )
    if st is None:
        return StitchVerdict(INFEASIBLE)
    # A single relaxed-limit phase is still one schedule — but one that only
    # exists because full replication is allowed; it lowers through the
    # stitched (sequential-loop) path so the memory plan bounds its residency.
    return StitchVerdict(STITCHABLE, stitched=st)
