"""Shared-memory (VMEM scratch) planning — paper §5.1.

Three phases, faithfully ported from GPU shared memory to TPU VMEM scratch:

  1. **Size-requirement analysis** (§5.1.1): non-root Reduce / fusable-Dot
     results MUST be buffered (their consumers use separate loop emitters);
     expensive elementwise ops with multiple in-fusion users SHOULD be
     buffered (compute reuse — true even for cheap ops); expensive
     elementwise ops transitively feeding a BatchDot through shape ops MUST
     be buffered (high data reuse inside the dot).

  2. **Size shrinking** (§5.1.2): when demand exceeds the per-kernel budget,
     drop optional buffers (recompute instead — thread composition) in the
     paper's priority order: cheap multi-user ew -> expensive multi-user ew
     -> expensive ew feeding a dot; ties broken by closeness to the root
     (smallest span first).  If *required* buffers alone exceed the budget,
     ``MemoryInfeasible`` propagates back to the fusion pass
     (ScheduleConsistencyChecker feedback).

  3. **Space sharing** (§5.1.3): build a dominance tree from the root
     (Cooper-Harvey-Kennedy on the reverse dataflow graph) and let an op
     reuse a buffer whose owner it dominates — by then the owner's value is
     provably dead.  We additionally verify deadness with explicit liveness
     on the emission order (belt and braces) and require identical
     chunk-shape/dtype so the Pallas scratch ref can be reused as-is.

On a GPU (``spec.is_gpu``) a slot lives in one CUDA block's shared memory:
each slot's bytes count rounded up to ``SLOT_ALIGN`` (the offsets
``geometry._slot_layout`` gives them), and a stitched kernel's staged
interfaces and whole-tensor I/O live in the global workspace, so each of its
phases plans against the whole budget (phases run in turn and share a
block's shared memory).  The TPU's plans are the reference's.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Dict, List, Optional, Set, Tuple

import numpy as np

from .ir import Instruction
from .schedule import ScheduleSolution, StitchedSolution, chunk_shape

if TYPE_CHECKING:    # latency imports geometry, which imports this module
    from .latency import DeviceSpec

#: bytes each slot of a generated CUDA kernel starts on (``geometry._slot_layout``)
SLOT_ALIGN = 16
#: the most members an inlined value's expression may compose where more
#: than one member of its kernel reads it: past it the value takes a slot,
#: since each reader composes the whole expression again, and a chain of
#: such values (a row written into a matrix whose earlier rows the row
#: reads, over and over) grows the kernel's text exponentially
COMPOSE_LIMIT = 64

ALLOC = "ALLOC"
SHARE = "SHARE"
INLINE = "INLINE"


class MemoryInfeasible(Exception):
    """Required buffers exceed the VMEM budget — feedback to fusion."""


@dataclass
class BufferEntry:
    action: str                 # ALLOC | SHARE | INLINE
    slot: int = -1              # scratch slot id (ALLOC/SHARE)
    nbytes: int = 0
    shape: Tuple[int, ...] = ()
    dtype: object = None
    required: bool = False


@dataclass
class MemoryPlan:
    entries: Dict[int, BufferEntry]         # instr id -> entry
    slots: List[Tuple[Tuple[int, ...], object]]   # slot id -> (shape, dtype)
    total_bytes: int
    shared_bytes: int
    shrunk: List[str] = field(default_factory=list)
    align: int = 1              # bytes each slot rounds up to in the budget

    @property
    def num_shrinks(self) -> int:
        return len(self.shrunk)

    @property
    def budget_bytes(self) -> int:
        """What the plan takes of the scratch budget: its slots, each
        rounded up to ``align``."""
        a = self.align
        return sum(-(-_nbytes(shape, dtype) // a) * a for shape, dtype in self.slots)

    @property
    def shared_ratio(self) -> float:
        return self.shared_bytes / self.total_bytes if self.total_bytes else 0.0

    def action(self, instr: Instruction) -> str:
        e = self.entries.get(instr.id)
        return e.action if e else INLINE


# --------------------------------------------------------------------------
# Dominance tree (Cooper-Harvey-Kennedy) on the reverse dataflow graph
# --------------------------------------------------------------------------


def dominance_tree(
    members: List[Instruction], roots: List[Instruction]
) -> Dict[int, Optional[int]]:
    """idom map over member ids; a virtual root (None) covers multi-root.

    Edges run root -> operands (reverse dataflow).  ``members`` is in
    module-topological order, so reversed order is a valid RPO from roots.
    """
    member_ids = {m.id for m in members}
    root_ids = {r.id for r in roots}
    order = [m for m in reversed(members)]          # users before producers
    index = {m.id: i for i, m in enumerate(order)}
    idom: Dict[int, Optional[int]] = {}
    VROOT = -1
    for r in roots:
        idom[r.id] = VROOT

    def intersect(a: int, b: int) -> int:
        while a != b:
            if a == VROOT or b == VROOT:
                return VROOT
            while index[a] > index[b]:
                a = idom[a]
                if a == VROOT:
                    return VROOT
            if a == b:
                break
            while index[b] > index[a]:
                b = idom[b]
                if b == VROOT:
                    return VROOT
        return a

    changed = True
    while changed:
        changed = False
        for m in order:
            preds = [u.id for u in m.users if u.id in member_ids]
            if m.id in root_ids:
                continue
            defined = [p for p in preds if p in idom]
            if not defined:
                continue
            new = defined[0]
            for p in defined[1:]:
                new = intersect(new, p)
            if idom.get(m.id) != new:
                idom[m.id] = new
                changed = True
    return idom


def dominates(a: int, b: int, idom: Dict[int, Optional[int]]) -> bool:
    """True if instruction ``a`` dominates instruction ``b``."""
    cur = b
    while cur is not None and cur != -1:
        if cur == a:
            return True
        cur = idom.get(cur, -1)
    return False


# --------------------------------------------------------------------------
# Planning
# --------------------------------------------------------------------------


def _feeds_dot_through_shape_ops(instr: Instruction, member_ids: Set[int]) -> bool:
    """Transitive use by an in-fusion BatchDot via shape-modulation ops
    (the paper's Divide.1 -> Bitcast.1 -> Dot.1 case)."""
    stack = list(instr.users)
    seen = set()
    while stack:
        u = stack.pop()
        if u.id in seen or u.id not in member_ids:
            continue
        seen.add(u.id)
        if u.opcode == "dot":
            return True
        if u.opcode in ("reshape", "bitcast", "transpose", "broadcast"):
            stack.extend(u.users)
    return False


def _nbytes(shape, dtype) -> int:
    return int(np.prod(shape, dtype=np.int64)) * np.dtype(dtype).itemsize


def slot_align(spec: Optional[DeviceSpec]) -> int:
    """Bytes a slot rounds up to in the budget: ``SLOT_ALIGN`` on a GPU."""
    return SLOT_ALIGN if spec is not None and spec.is_gpu else 1


def plan_memory(
    members: List[Instruction],
    roots: List[Instruction],
    solution: ScheduleSolution,
    vmem_limit: int = 4 * 1024 * 1024,
    spec: Optional[DeviceSpec] = None,
) -> MemoryPlan:
    """Plan one kernel's scratch against ``vmem_limit`` (module docstring);
    ``spec`` is the device the plan is for (None: the TPU's rules)."""
    align = slot_align(spec)
    member_ids = {m.id for m in members}
    root_ids = {r.id for r in roots}

    # ---- phase 1: size requirements (candidates) -------------------------
    # category: 0=required, 1=cheap multi-user, 2=expensive multi-user,
    #           3=expensive feeding dot  (shrink order: 1 -> 2 -> 3, never 0)
    candidates: Dict[int, int] = {}
    composed: Dict[int, int] = {}     # members an inlined value composes
    for m in members:
        composed[m.id] = 1 + sum(composed.get(o.id, 0) for o in m.operands)
        in_users = [u for u in m.users if u.id in member_ids]
        if m.id in root_ids and not in_users:
            continue  # pure output: written straight to the output ref
        if m.id in solution.index_values:
            continue  # recomputed from its index where it is read
        if m.opcode in ("reduce", "dot", "cumsum") or (
                len(in_users) > 1 and composed[m.id] > COMPOSE_LIMIT):
            candidates[m.id] = 0
            composed[m.id] = 1
        elif m.opcode == "elementwise":
            feeds_dot = _feeds_dot_through_shape_ops(m, member_ids)
            if m.is_expensive and feeds_dot:
                candidates[m.id] = 3
            elif m.is_expensive and len(in_users) > 1:
                candidates[m.id] = 2
            elif len(in_users) > 1:
                candidates[m.id] = 1
            if m.id in candidates:
                composed[m.id] = 1

    sizes: Dict[int, Tuple[Tuple[int, ...], int]] = {}
    for m in members:
        if m.id in candidates:
            cs = chunk_shape(m.shape, solution.sched(m))
            nbytes = int(np.prod(cs, dtype=np.int64)) * np.dtype(m.dtype).itemsize
            sizes[m.id] = (tuple(cs), nbytes)

    # ---- phase 2: size shrinking -----------------------------------------
    span_rank = {m.id: i for i, m in enumerate(members)}  # later = closer root
    shrunk: List[str] = []

    def demand() -> int:
        return sum(-(-sizes[i][1] // align) * align for i in candidates)

    while demand() > vmem_limit:
        droppable = [i for i, cat in candidates.items() if cat > 0]
        if not droppable:
            raise MemoryInfeasible(
                f"required buffers need {demand()}B > {vmem_limit}B budget"
            )
        # paper order: category 1, then 2, then 3; within a category the
        # op closest to the root goes first.
        droppable.sort(key=lambda i: (candidates[i], -span_rank[i]))
        victim = droppable[0]
        name = next(m.name for m in members if m.id == victim)
        shrunk.append(name)
        del candidates[victim]

    # ---- phase 3: space sharing via dominance ----------------------------
    idom = dominance_tree(members, roots)
    # liveness on emission (topo) order: value of i is dead after its last
    # in-fusion user's position.
    last_use: Dict[int, int] = {}
    for pos, m in enumerate(members):
        for o in m.operands:
            if o.id in member_ids:
                last_use[o.id] = pos

    entries: Dict[int, BufferEntry] = {}
    slots: List[Tuple[Tuple[int, ...], object]] = []
    slot_owner: List[Optional[int]] = []     # current live owner per slot
    total = 0
    shared = 0
    for pos, m in enumerate(members):
        if m.id not in candidates:
            continue
        cs, nbytes = sizes[m.id]
        # find a reusable slot: same shape/dtype, previous owner's value
        # dead (liveness), and we dominate the previous owner (paper's rule)
        reuse = None
        for s, (sshape, sdtype) in enumerate(slots):
            prev = slot_owner[s]
            if sshape != cs or np.dtype(sdtype) != np.dtype(m.dtype):
                continue
            if prev is None:
                continue
            if last_use.get(prev, -1) < pos and dominates(m.id, prev, idom):
                reuse = s
                break
        if reuse is not None:
            entries[m.id] = BufferEntry(
                SHARE, reuse, nbytes, cs, m.dtype, candidates[m.id] == 0
            )
            slot_owner[reuse] = m.id
            shared += nbytes
        else:
            slots.append((cs, m.dtype))
            slot_owner.append(m.id)
            entries[m.id] = BufferEntry(
                ALLOC, len(slots) - 1, nbytes, cs, m.dtype, candidates[m.id] == 0
            )
            total += nbytes
    for m in members:
        if m.id not in entries:
            entries[m.id] = BufferEntry(INLINE)

    return MemoryPlan(entries, slots, total, shared, shrunk, align)


# --------------------------------------------------------------------------
# Stitched (multi-phase) planning: full interface buffers + per-phase scratch
# --------------------------------------------------------------------------


@dataclass
class InterfaceBuffer:
    """One staged phase-boundary tensor, materialized WHOLE in VMEM."""

    slot: int
    shape: Tuple[int, ...]
    dtype: object
    nbytes: int
    produced_phase: int
    last_consumer_phase: int


@dataclass
class StitchedMemoryPlan:
    """VMEM plan for a multi-phase stitched kernel.

    Interface tensors are allocated at FULL (untiled) size — the producer
    phase writes each block's chunk into the staging buffer and the consumer
    phase re-tiles it under its own schedule.  Each phase additionally gets
    its own chunk-granular ``MemoryPlan`` for phase-interior buffering.

    Feasibility matches what ``emit_stitched_fusion`` actually allocates:
    every interface buffer AND every phase's scratch slots are passed to one
    ``pallas_call`` and coexist for the whole kernel, so the budget is
    consumed sequentially — each phase plans (and shrinks) against whatever
    the interfaces and earlier phases left over.  ``MemoryInfeasible``
    propagates back to the fusion pass so infeasible stitches fall back to
    a split.
    """

    interfaces: Dict[int, InterfaceBuffer]     # instr id -> staged buffer
    phase_plans: List[MemoryPlan]
    interface_bytes: int
    io_bytes: int = 0        # whole-tensor input/output blocks (trivial grid)
    # False on a GPU: interfaces and I/O live in the global workspace, and
    # the phases take a block's shared memory in turn
    staged_in_scratch: bool = True

    @property
    def num_phases(self) -> int:
        return len(self.phase_plans)

    @property
    def budget_bytes(self) -> int:
        """What the plan takes of the scratch budget: interfaces, I/O and
        every phase's slots at once, or on a GPU its largest phase."""
        if self.staged_in_scratch:
            return self.total_bytes + self.io_bytes
        return max((p.budget_bytes for p in self.phase_plans), default=0)

    # ---- MemoryPlan-compatible reporting surface -------------------------
    @property
    def total_bytes(self) -> int:
        """Whole-kernel VMEM residency: interfaces + every phase's slots
        (they all coexist in the one pallas_call's scratch set)."""
        return self.interface_bytes + sum(p.total_bytes for p in self.phase_plans)

    @property
    def shared_bytes(self) -> int:
        return sum(p.shared_bytes for p in self.phase_plans)

    @property
    def num_shrinks(self) -> int:
        return sum(p.num_shrinks for p in self.phase_plans)

    @property
    def shared_ratio(self) -> float:
        return self.shared_bytes / self.total_bytes if self.total_bytes else 0.0


def plan_stitched_memory(
    stitched: StitchedSolution,
    vmem_limit: int = 4 * 1024 * 1024,
    spec: Optional[DeviceSpec] = None,
) -> StitchedMemoryPlan:
    """Plan VMEM for a stitched kernel: one full-size staging buffer per
    interface tensor plus one chunk-granular plan per phase, checked against
    ``vmem_limit`` as ONE allocation together with the whole-tensor kernel
    input/output blocks — exactly the VMEM working set the stitched emitter
    hands to ``pallas_call`` (trivial grid, full BlockSpecs)."""
    phase_of: Dict[int, int] = {}
    for k, p in enumerate(stitched.phases):
        for m in p.members:
            phase_of[m.id] = k

    interfaces: Dict[int, InterfaceBuffer] = {}
    for slot, i in enumerate(stitched.interfaces):
        last = max(
            (phase_of[u.id] for u in i.users if u.id in phase_of),
            default=phase_of[i.id],
        )
        interfaces[i.id] = InterfaceBuffer(
            slot=slot,
            shape=tuple(i.shape),
            dtype=i.dtype,
            nbytes=int(i.bytesize),
            produced_phase=phase_of[i.id],
            last_consumer_phase=last,
        )

    # the stitched emitter's trivial grid gives every kernel input and every
    # kernel output a WHOLE-tensor BlockSpec, so those blocks are VMEM-
    # resident for the entire kernel too (unlike the chunk-sized blocks of a
    # schedule-consistent kernel) — they must come out of the same budget
    group_ids = set(phase_of)
    io_bytes = 0
    seen_io = set()
    for p in stitched.phases:
        for m in p.members:
            for o in m.operands:
                if o.id not in group_ids and o.id not in seen_io:
                    seen_io.add(o.id)
                    io_bytes += int(o.bytesize)
            if m.id not in seen_io and (
                not m.users or any(u.id not in group_ids for u in m.users)
            ):
                seen_io.add(m.id)
                io_bytes += int(m.bytesize)

    iface_bytes = sum(b.nbytes for b in interfaces.values())
    if spec is not None and spec.is_gpu:
        # interfaces and I/O in the global workspace; each phase has the
        # whole of a block's shared memory while it runs
        phase_plans = [plan_memory(p.members, p.roots, p.solution, vmem_limit, spec)
                       for p in stitched.phases]
        return StitchedMemoryPlan(interfaces, phase_plans, iface_bytes, io_bytes,
                                  staged_in_scratch=False)
    if iface_bytes + io_bytes > vmem_limit:
        raise MemoryInfeasible(
            f"staged interfaces ({iface_bytes}B) + whole-tensor kernel I/O "
            f"({io_bytes}B) > {vmem_limit}B budget"
        )
    phase_plans: List[MemoryPlan] = []
    remaining = vmem_limit - iface_bytes - io_bytes
    for p in stitched.phases:
        # every phase's slots coexist with the interfaces and with every
        # other phase's slots for the whole kernel, so each phase plans
        # (and shrinks) against what earlier phases left over; a phase
        # whose REQUIRED buffers exceed that raises MemoryInfeasible
        plan = plan_memory(p.members, p.roots, p.solution, remaining)
        phase_plans.append(plan)
        remaining -= plan.total_bytes

    return StitchedMemoryPlan(interfaces, phase_plans, iface_bytes, io_bytes)
