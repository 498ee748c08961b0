"""The launch geometry of a generated kernel on the H100, decided once.

What a kernel of ``core/codegen.py`` launches is decided here, for each of
its phases, in one ``PhaseLaunch``: the CUDA blocks its loops keep busy and
the threads a block; the members that write a slot, the slots' offsets and
where they live (a block's shared memory, or past ``SMEM_LIMIT`` a
per-block region of the workspace); the members held in a register in
place of their slot; the independent member groups a single-phase kernel
runs on CUDA blocks of their own; where a staged dot's operand tiles start;
and the loop each fused dot takes (its ``DotTiling``, or None for the
register-tile loop); and the blocks an SM the compiler is asked to fit
(``PhaseLaunch.blocks_per_sm``).  Two readers take it as it is: the
planner's GPU cost model (``latency.LatencyModel.fusion_time``,
``stitched_fusion_time``) charges a plan by it, and the emitter (``codegen._cuda_fusion``,
``_cuda_stitched``, ``_Phase``) writes it into the kernel's text.  Neither
works it out again.  The emitter keeps only what the text itself decides:
the index width (``codegen._wide``), from the loops it forms.

The cost model reads every field but ``blocks_per_sm``.  It counts the
blocks an SM holds by their threads alone (``latency.LatencyModel.waves``),
for every kernel alike: what registers allow is the compiler's count, which
the planner does not have.  ``blocks_per_sm`` caps those registers, so that
the compiler's count does not fall below it; it moves no count the model
makes.

This module sits below the cost model: it imports ``ir``, ``schedule`` and
``memory`` only, and ``latency`` imports it.  The arrows run one way:
ir -> schedule -> memory -> geometry -> latency -> tuning / fusion ->
codegen -> pipeline.  The constants the planner's budget and the verifier
read (``SMEM_LIMIT``, ``reduce_part_bytes``) live here too.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from functools import lru_cache
from typing import Dict, FrozenSet, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from .ir import BFLOAT16, Instruction, _prod, dtype_name
from .memory import ALLOC, SHARE, SLOT_ALIGN, MemoryPlan, StitchedMemoryPlan
from .schedule import ScheduleSolution, Sched, StitchedSolution, chunk_shape, propagate

#: threads per block of a kernel (``stitched_threads``, ``fusion_launch``)
STITCHED_MIN_THREADS, STITCHED_MAX_THREADS = 128, 512
STITCHED_ELEMS_PER_THREAD = 16
#: shared memory one H100 block may use (dynamic, past 48 KB only after
#: cudaFuncSetAttribute); slots of a phase that need more live in the workspace
SMEM_LIMIT = 232_448
STATIC_SMEM_LIMIT = 48 * 1024
#: shared memory of one H100 SM, of which each resident block reserves 1 KB
SM_SMEM, BLOCK_SMEM_RESERVED = 233_472, 1024
#: where a phase's slots live (``PhaseLaunch.slots_in``)
SHARED, WORKSPACE = "shared memory", "a per-block workspace region"

# each dtype's C type in memory, and the type its values are computed in:
# bf16 and f16 compute in float, int8, uint8 and int16 in int, and every member's
# value is rounded (or wrapped) back to its dtype where the member ends, as
# the reference's per-instruction ``apply_op`` does
_C_TYPES = {
    np.dtype(np.float32): ("float", "float"),
    np.dtype(np.float64): ("double", "double"),
    np.dtype(np.int32): ("int", "int"),
    np.dtype(np.int64): ("long long", "long long"),
    np.dtype(np.bool_): ("bool", "bool"),
    np.dtype(np.float16): ("__half", "float"),
    BFLOAT16: ("__nv_bfloat16", "float"),
    np.dtype(np.int8): ("signed char", "int"),
    np.dtype(np.uint8): ("unsigned char", "int"),
    np.dtype(np.int16): ("short", "int"),
}
# the type each C compute type is, for its size
_NP_COMPUTE = {"float": np.float32, "double": np.float64, "int": np.int32,
               "long long": np.int64, "bool": np.bool_}


def _c_types(dtype) -> Tuple[str, str]:
    try:
        return _C_TYPES[np.dtype(dtype)]
    except KeyError:
        raise NotImplementedError(
            f"the CUDA emitters take {sorted(dtype_name(d) for d in _C_TYPES)}, "
            f"not {dtype_name(dtype)}"
        ) from None


def _c_compute(dtype) -> str:
    """The C type a ``dtype`` value is computed in."""
    return _c_types(dtype)[1]


# --------------------------------------------------------------------------
# threads, slots and the members that write them
# --------------------------------------------------------------------------


def reduce_part_bytes(threads: int) -> int:
    """Static shared memory of a block reduce's partial results: one
    8-byte value per warp."""
    return threads // 32 * 8


def _threads_for(work: int) -> int:
    """The fewest threads, from 128 up to 512 in powers of two, that
    ``work`` threads' worth of parallelism asks for."""
    t = STITCHED_MIN_THREADS
    while t < STITCHED_MAX_THREADS and t < work:
        t *= 2
    return t


def stitched_threads(plan: StitchedMemoryPlan) -> int:
    """Threads of each block of a stitched kernel.  A plan block with slots
    runs on one CUDA block, so its threads are all the parallelism that
    plan block gets: the fewest, from 128 up to 512, that leave its
    largest slot at most ``STITCHED_ELEMS_PER_THREAD`` elements a thread.
    512 is the cap because ``__launch_bounds__(512)`` still leaves 128
    registers a thread for the composed expressions."""
    largest = max((_prod(shape) for pp in plan.phase_plans for shape, _ in pp.slots), default=0)
    return _threads_for(-(-largest // STITCHED_ELEMS_PER_THREAD))


def _slot_layout(pplan: MemoryPlan, used) -> Tuple[Dict[int, int], int]:
    """Byte offsets of the slots of a phase plan that members still write
    (``used``), each 16-byte aligned, in slot order, and their total: the
    shared memory (or per-block workspace region) the phase's tiled
    ALLOC/SHARE members live in."""
    offs, size = {}, 0
    for slot, (shape, dtype) in enumerate(pplan.slots):
        if slot in used:
            offs[slot] = size
            size += -(-_prod(shape) * np.dtype(dtype).itemsize // SLOT_ALIGN) * SLOT_ALIGN
    return offs, size


#: members whose element ``i`` is computed from element ``i`` of each operand
_PER_ELEMENT = ("elementwise", "select")


def _tile_slots(members: Sequence[Instruction], pplan: MemoryPlan, held=frozenset()) -> Dict[int, int]:
    """Each member of a phase that writes a tile, and its slot: the plan's
    ALLOC/SHARE members but constants (read as literals) and ``held``."""
    out = {}
    for m in members:
        e = pplan.entries.get(m.id)
        if e is not None and e.action in (ALLOC, SHARE) and m.opcode != "constant" and m.id not in held:
            out[m.id] = e.slot
    return out


def held_in_registers(members: Sequence[Instruction], assign, pplan: MemoryPlan, written) -> set:
    """The ALLOC/SHARE members of one phase that are held in a register in
    place of their slot.  Such a member is per-element (``_PER_ELEMENT``),
    the phase need not write it (``written``: its outputs and staged
    interfaces), every reader reads it at the very element it would have
    written (the same ``Sched`` and tile, no re-tiling through ``_adapt``,
    and only per-element members between it and the loop that reads it),
    it reads every slot it reads at that element too (a member that reads
    a slot across threads, as a transposed SHARE member does, keeps its
    tile), and no member overwrites a slot it reads before that loop.  Each
    loop that reads it computes it once per element, from the same operands
    in the same order with the same roundings: its slot bought nothing but
    a round trip through memory and a barrier."""
    ids = {m.id: m for m in members}
    pos = {m.id: k for k, m in enumerate(members)}
    tiles = _tile_slots(members, pplan)
    held = {i for i in tiles if ids[i].opcode in _PER_ELEMENT and i not in written}

    def loops(x: Instruction) -> Optional[set]:
        """The loops that compute ``x`` where it is held, or None where a
        reader reads it at another element (or outside the phase)."""
        out = set()
        for u in x.users:
            if u.id not in ids and x.id in written:
                continue                   # it reads x where x is written
            if u.id not in ids or u.opcode not in _PER_ELEMENT or tuple(u.shape) != tuple(x.shape):
                return None
            for o, ns in zip(u.operands, propagate(u, assign[u.id], True), strict=False):
                if o.id == x.id and ns != assign[x.id]:
                    return None
            if u.id in tiles and u.id not in held:
                out.add(u.id)              # it reads x in its own loop
                continue
            if u.id in written:
                out.add(u.id)
            inner = loops(u)               # u is composed into its readers
            if inner is None:
                return None
            out |= inner
        return out

    def slots_read(m: Instruction) -> Dict[int, bool]:
        """The slots ``m``'s value reads, each True where every read is at
        ``m``'s own element."""
        out: Dict[int, bool] = {}
        for o, ns in zip(m.operands, propagate(m, assign[m.id], True), strict=False):
            if o.id not in ids or o.opcode == "constant":
                continue
            same = (m.opcode in _PER_ELEMENT and ns == assign[o.id]
                    and tuple(o.shape) == tuple(m.shape))
            reads = {tiles[o.id]: True} if o.id in tiles and o.id not in held else slots_read(o)
            for slot, own in reads.items():
                out[slot] = out.get(slot, True) and own and same
        return out

    def keeps(x: Instruction) -> bool:
        where = loops(x)
        read = slots_read(x)
        if where is None or not all(read.values()):
            return False
        return not any(pos[x.id] < pos[w] < pos[u] and tiles[w] in read
                       for u in where for w in tiles if w not in held)

    changed = True
    while changed:
        dropped = {i for i in held if not keeps(ids[i])}
        held -= dropped
        changed = bool(dropped)
    return held


def _stored_tiles(members: Sequence[Instruction], solution: ScheduleSolution, plan, written
                  ) -> Tuple[FrozenSet[int], Dict[int, int]]:
    """(the members held in a register, the members of a phase that write a
    slot and their slots): ``held_in_registers``, then ``_tile_slots``;
    without a memory plan, nothing held and each reduce, dot or running sum
    read inside the phase in slot 0, the buffers ``memory.plan_memory``
    always requires."""
    if plan is not None:
        held = frozenset(held_in_registers(members, solution.assignment, plan, written))
        return held, _tile_slots(members, plan, held)
    ids = {m.id for m in members}
    return frozenset(), {m.id: 0 for m in members if m.opcode in ("reduce", "dot", "cumsum")
                         and any(u.id in ids for u in m.users)}


def _independent_groups(members: Sequence[Instruction]) -> List[List[int]]:
    """The member ids of a fusion split into groups that share no value
    (constants, read as literals, join none), each in topological order,
    the groups in the order of their first member.  No group reads what
    another writes, so each may run on a CUDA block of its own."""
    parent = {m.id: m.id for m in members}

    def find(x: int) -> int:
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for m in members:
        if m.opcode == "constant":
            continue
        for o in m.operands:
            if o.id in parent and o.opcode != "constant":
                parent[find(o.id)] = find(m.id)
    groups: Dict[int, List[int]] = {}
    for m in members:
        groups.setdefault(find(m.id), []).append(m.id)
    return list(groups.values())


# --------------------------------------------------------------------------
# the loop each fused dot takes
# --------------------------------------------------------------------------

#: k steps a staged dot stages at once, at most (``dot_tiling``)
DOT_MAX_BK = 32
#: threads a staged dot's tile keeps busy before a larger register tile wins
DOT_BUSY = 256
#: rows of a thread's register tile, tried largest first: f32 tiles of 8
#: rows read their lhs in two 16-byte words
DOT_ROWS = (8, 4, 2, 1)
#: registers a thread may hold the next k step's staged values in, at most
DOT_PREFETCH = 16
#: the same on the tensor cores: a quarter of the registers a thread may use
#: at its block's size (65,536 a block), since the next step's values in
#: flight are what hides the loads' latency
DOT_MMA_PREFETCH_SHARE = 4
#: words of padding at the end of each staged row, against bank conflicts;
#: rows read in 16-byte words (``DotTiling.vec``) keep their alignment
DOT_PAD, DOT_VEC_PAD = 1, 4
#: 2-byte elements of padding at the end of each row staged for the tensor
#: cores: rows stay 16-byte aligned for ``ldmatrix``, and a row of a
#: multiple of 16 elements plus 8 is an odd count of 16-byte words, so the
#: eight rows one ``ldmatrix`` matrix reads fall in eight distinct banks
DOT_MMA_PAD = 8
#: f32 accumulators a thread may hold in the tensor-core form, at most (as
#: the FMA loop's largest register tile, 8 x 4)
DOT_MMA_ACC = 32
#: the element types ``mma.sync`` m16n8k16 multiplies, with f32 sums
_MMA_TYPES = {BFLOAT16: "bf16", np.dtype(np.float16): "f16"}
#: on the tensor cores, a depth up to this is staged in one k step (no k
#: loop, no barrier between steps); a deeper one in steps of 16, the fewest
#: staged values a thread holds for the next step
DOT_MMA_ONE_STEP = 64


def _reg_tile(rows: int, cols: int) -> Tuple[int, int]:
    """A thread's register tile of a dot's outputs in the register-tile
    loop: up to 4 x 4."""
    return (next(r for r in (4, 2, 1) if rows % r == 0),
            next(r for r in (4, 2, 1) if cols % r == 0))


def _divisors_of(n: int, cap: int = 0) -> List[int]:
    """The divisors of ``n``, ascending; up to ``cap`` where it is given."""
    small = [d for d in range(1, math.isqrt(n) + 1) if n % d == 0]
    out = sorted(set(small + [n // d for d in small]))
    return [d for d in out if d <= cap] if cap else out


@dataclass(frozen=True)
class DotTiling:
    """How a staged dot walks one plan block's output chunk: tiles of BG
    batch elements of BM x BN outputs, each thread an rm x rn register tile
    of one, k in steps of BK, ``lhs[BG x BM x BK]`` and ``rhs[BG x BK x
    BN]`` staged in shared memory at each step as ``[BG][BK][BM + pad]``
    and ``[BG][BK][BN + pad]``.  ``vec``: each thread's rows (and columns)
    are neighbours, read from shared memory in 16-byte words; else they are
    strided by the tile's count of threads along them.

    ``warps`` (the tensor-core form, both operands bf16 or both f16): the
    warps along BM and along BN that split the tile, each a ``warp_tile``
    of m16 x n8 pieces, computed by ``mma.sync`` m16n8k16 with f32 sums
    from operands staged in their own 2-byte type and read by ``ldmatrix``;
    empty, the FMA loop of rm x rn register tiles.  ``kmajor`` (the
    tensor-core form): for the lhs and the rhs, whether its source is
    contiguous along k, and the operand is then staged as ``[BM][BK + pad]``
    (``[BN][BK + pad]``), so its staging reads and writes whole rows of k."""

    bm: int
    bn: int
    bk: int
    rm: int
    rn: int
    bg: int = 1
    vec: bool = False
    warps: Tuple[int, ...] = ()
    kmajor: Tuple[bool, ...] = ()

    @property
    def pad(self) -> int:
        if self.warps:
            return DOT_MMA_PAD
        return DOT_VEC_PAD if self.vec else DOT_PAD

    @property
    def warp_tile(self) -> Tuple[int, int]:
        """Each warp's rows and columns of the tile (the tensor-core form)."""
        return self.bm // self.warps[0], self.bn // self.warps[1]

    def pitch(self, which: int) -> int:
        """Elements from one staged row of the lhs (``which`` 0) or the rhs
        (1) to the next: BK + pad where it is staged k-major, else its
        rows' or columns' count + pad."""
        if self.kmajor and self.kmajor[which]:
            return self.bk + self.pad
        return (self.bm, self.bn)[which] + self.pad

    def _bytes(self, which: int, itemsize: int) -> int:
        rows = (self.bm, self.bn)[which] if self.kmajor and self.kmajor[which] else self.bk
        return -(-self.bg * rows * self.pitch(which) * itemsize // SLOT_ALIGN) * SLOT_ALIGN

    def a_bytes(self, itemsize: int) -> int:
        return self._bytes(0, itemsize)

    def stage_bytes(self, itemsize: int) -> int:
        return self._bytes(0, itemsize) + self._bytes(1, itemsize)


def dot_tiling(m: Instruction, sched: Sched, threads: int, budget: int,
               lhs_ops: int = 0, rhs_ops: int = 0,
               along_k: Tuple[bool, bool] = (False, False)) -> Optional[DotTiling]:
    """The staged loop's tiling of dot ``m`` under ``sched`` in blocks of
    ``threads`` threads, its staging within ``budget`` bytes of shared
    memory, or None where no staging fits (the register-tile loop serves
    it).  A tile keeps as many threads busy as the chunk allows, up to
    ``DOT_BUSY``; then the largest register tile (f32 up to 8 x 4, other
    types 4 x 4: shared memory's bandwidth bounds the loop, and a larger
    tile reads less of it for each FMA); then the tile that stages the
    fewest values, each weighted by one plus the operations composed into
    its operand (``lhs_ops``, ``rhs_ops``): the lhs is staged once per
    column tile, the rhs once per row tile.  f32 register tiles read
    shared memory in 16-byte words (8-byte for two).

    A dot whose operands are both bf16 or both f16, and whose depth is a
    multiple of 16, takes the tensor-core form in the first tile of that
    ranking that ``mma_warps`` splits over the block's warps, its staging
    in 2-byte elements within ``budget``, each operand whose source is
    contiguous along k (``along_k``) staged k-major, k in one step up to
    ``DOT_MMA_ONE_STEP`` and else in steps of 16; where none does, it keeps
    the FMA loop."""
    out_chunk = chunk_shape(m.shape, sched)
    rows, cols = out_chunk[-2], out_chunk[-1]
    batch = _prod(out_chunk[:-2])
    depth = m.operands[0].shape[-1]
    itemsize = np.dtype(_NP_COMPUTE[_c_compute(m.dtype)]).itemsize
    vec = _c_compute(m.dtype) == "float"
    ranked = _ranked_tiles(rows, cols, batch, depth, vec, threads, lhs_ops, rhs_ops)
    if mma_type(m) and vec and depth % 16 == 0:
        steps = ([depth] if depth <= DOT_MMA_ONE_STEP else []) + [16]
        for bm, bn, rm, rn, bg in ranked:
            warps = mma_warps(bm, bn, threads) if bg == 1 else None
            for bk in (steps if warps else []):
                t = DotTiling(bm, bn, bk, rm, rn, bg, vec, warps, tuple(along_k))
                if t.stage_bytes(2) <= budget:
                    return t
    for bm, bn, rm, rn, bg in ranked:
        for bk in reversed([d for d in _divisors_of(depth) if d <= DOT_MAX_BK]):
            t = DotTiling(bm, bn, bk, rm, rn, bg, vec)
            if t.stage_bytes(itemsize) <= budget:
                return t
    return None


@lru_cache(maxsize=4096)
def _ranked_tiles(rows: int, cols: int, batch: int, depth: int, vec: bool, threads: int,
                  lhs_ops: int, rhs_ops: int) -> Tuple[Tuple[int, int, int, int, int], ...]:
    """``dot_tiling``'s ranking of the (bm, bn, rm, rn, bg) tiles of a
    rows x cols output chunk of ``batch`` products of ``depth``, best
    first; once an argument tuple, as the planner costs the same dots over
    and over."""
    keyed = []
    for rm in (r for r in DOT_ROWS if rows % r == 0 and (vec or r <= 4)):
        for rn in (r for r in (4, 2, 1) if cols % r == 0):
            for bg in _divisors_of(batch, threads):
                for tx in _divisors_of(cols // rn, threads // bg):
                    for ty in _divisors_of(rows // rm, threads // (bg * tx)):
                        bm, bn = ty * rm, tx * rn
                        staged = ((1 + lhs_ops) * rows * depth * (cols // bn)
                                  + (1 + rhs_ops) * depth * cols * (rows // bm))
                        busy = bg * tx * ty
                        keyed.append(((min(busy, DOT_BUSY), rm * rn, -staged, bn, busy, rn, -bg),
                                      (bm, bn, rm, rn, bg)))
    return tuple(tile for _, tile in sorted(keyed, reverse=True))


def staged_itemsize(m: Instruction, t: DotTiling) -> int:
    """Bytes of one staged element of dot ``m`` tiled as ``t``: on the
    tensor cores the operands' own 2-byte type, else the type ``m``
    computes in."""
    return 2 if t.warps else np.dtype(_NP_COMPUTE[_c_compute(m.dtype)]).itemsize


def _blocks_per_sm(launches: Sequence["PhaseLaunch"], members: Sequence[Instruction]
                   ) -> Tuple["PhaseLaunch", ...]:
    """``launches``, the phases of one kernel over ``members``, with the
    blocks an SM it asks the compiler to fit (the second bound of
    ``__launch_bounds__``): two where blocks of 512 threads hold a dot on
    the tensor cores and two fit the SM's shared memory (the slots, the
    staged operand tiles and a block-wide reduce's partials), since their
    registers (up to 128 a thread) would otherwise leave one block an SM,
    its 16 warps at one barrier at once and none to run while they wait for
    a k step's loads; else one, the compiler's own choice."""
    by_id = {m.id: m for m in members}
    threads = launches[0].threads
    dots = [(launch.dot_offset, by_id[i], t) for launch in launches
            for i, t in launch.tilings.items() if t is not None]
    if threads != STITCHED_MAX_THREADS or not any(t.warps for _, _, t in dots):
        return tuple(launches)
    smem = max([launch.slot_bytes for launch in launches if launch.slots_in == SHARED]
               + [offset + t.stage_bytes(staged_itemsize(m, t)) for offset, m, t in dots])
    if 2 * (smem + reduce_part_bytes(threads) + BLOCK_SMEM_RESERVED) > SM_SMEM:
        return tuple(launches)
    return tuple(replace(launch, blocks_per_sm=2) for launch in launches)


def dot_prefetch(t: DotTiling, threads: int) -> int:
    """The staged values a thread of ``threads`` may hold in registers for
    the next k step of a dot tiled as ``t``, at most."""
    return 65536 // threads // DOT_MMA_PREFETCH_SHARE if t.warps else DOT_PREFETCH


def mma_type(m: Instruction) -> Optional[str]:
    """``bf16`` or ``f16`` where both operands of dot ``m`` are of that
    type (``mma.sync`` m16n8k16 takes them with f32 sums), else None."""
    kinds = {_MMA_TYPES.get(np.dtype(o.dtype)) for o in m.operands}
    return kinds.pop() if len(kinds) == 1 else None


def mma_warps(bm: int, bn: int, threads: int) -> Optional[Tuple[int, int]]:
    """The warps along BM and along BN that split a BM x BN tile for the
    tensor cores, each warp's tile a whole number of m16 pieces by pairs of
    n8 pieces (one ``ldmatrix.x4`` reads a pair's rhs): as many of the
    block's warps as the tile takes, at most ``DOT_MMA_ACC`` f32 sums a
    thread, then the squarest warp tile (the fewest shared-memory reads
    for each product); None where no split fits."""
    best = None
    for wm in (d for d in _divisors_of(bm) if d % 16 == 0):
        for wn in (d for d in _divisors_of(bn) if d % 16 == 0):
            n = (bm // wm) * (bn // wn)
            if n > threads // 32 or wm * wn > 32 * DOT_MMA_ACC:
                continue
            key = (n, -(wm + wn), wm)
            if best is None or key > best[0]:
                best = (key, (bm // wm, bn // wn))
    return best[1] if best else None


def _composed_ops(o: Instruction, composed) -> int:
    """The operations (elementwise, select) composed into a read of ``o``:
    ``o`` and what it is computed from, through the members in
    ``composed`` (INLINE or held in a register)."""
    stack, seen, n = [o], set(), 0
    while stack:
        x = stack.pop()
        if x.id in seen or x.id not in composed:
            continue
        seen.add(x.id)
        if x.opcode in ("elementwise", "select"):
            n += 1
        stack.extend(x.operands)
    return n


def minor_moved(o: Instruction, composed) -> bool:
    """Whether a composed read of ``o`` goes through a transpose that moves
    its minor dimension: the source is then contiguous along another
    dimension of ``o`` than its last."""
    stack, seen = [o], set()
    while stack:
        x = stack.pop()
        if x.id in seen or x.id not in composed:
            continue
        seen.add(x.id)
        if x.opcode == "transpose":
            perm = tuple(x.attrs["perm"])
            if perm[-1] != len(perm) - 1:
                return True
        if x.opcode in ("elementwise", "select", "reshape", "bitcast", "broadcast", "transpose"):
            stack.extend(x.operands)
    return False


def staged_dot_tiling(m: Instruction, sched: Sched, threads: int, budget: int,
                      composed) -> Optional[DotTiling]:
    """``dot_tiling`` of ``m`` with its operands' composed operations
    counted over ``composed``, the member ids read through composition,
    and the dimension each operand's source is contiguous along."""
    lhs, rhs = m.operands
    return dot_tiling(m, sched, threads, budget, _composed_ops(lhs, composed),
                      _composed_ops(rhs, composed),
                      (not minor_moved(lhs, composed), minor_moved(rhs, composed)))


def _dot_tiles(m: Instruction, sched: Sched, t: DotTiling) -> int:
    """Tiles of one plan block's chunk of dot ``m``."""
    out_chunk = chunk_shape(m.shape, sched)
    return _prod(out_chunk[:-2]) // t.bg * (out_chunk[-2] // t.bm) * (out_chunk[-1] // t.bn)


# --------------------------------------------------------------------------
# the launch of each phase
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class PhaseLaunch:
    """One phase of a generated kernel as the H100 launches it: the single
    phase of an ``emit_fusion`` kernel, or a phase of an
    ``emit_stitched_fusion`` kernel's cooperative launch."""

    grid: int                         # CUDA blocks the phase's loops keep busy
    threads: int                      # threads a block (a stitched kernel's every phase alike)
    held: FrozenSet[int]              # ALLOC/SHARE members held in a register, not their slot
    tiles: Mapping[int, int]          # member id -> the slot it writes
    slot_offsets: Mapping[int, int]   # slot -> its byte offset
    slot_bytes: int                   # the slots members write, in all
    slots_in: Optional[str]           # SHARED or WORKSPACE; None: no slot, a pure map
    dot_offset: int                   # where a staged dot's operand tiles start in shared memory
    tilings: Mapping[int, Optional[DotTiling]]   # each dot's staged loop; None: register tiles
    # a single-phase kernel with slots: its member groups that share no value
    # (``_independent_groups``) and write something, a CUDA block each for
    # each plan block; None: one group
    groups: Optional[Tuple[Tuple[int, ...], ...]]
    # blocks an SM the compiler is asked to fit (``_blocks_per_sm``; a
    # stitched kernel's every phase alike); 1: its own choice
    blocks_per_sm: int = 1


def _map_loop_grid(m: Instruction, sched: Sched, blocks: int, threads: int,
                   tiling: Optional[DotTiling]) -> int:
    """Blocks a pure map's loop over ``m`` keeps busy (``_Phase._loop_head``,
    ``reduce_loop``, ``dot_loop`` with no slot base): its elements, a
    warp per reduce output, a block per tile of a staged dot (``tiling``),
    or a thread per register tile of an unstaged one, over every plan
    block, ``threads`` a block."""
    reps = blocks if sched.kind == "chunked" else 1
    out_chunk = chunk_shape(m.shape, sched)
    if m.opcode == "reduce":
        return -(-_prod(out_chunk) * reps * 32 // threads)
    if m.opcode == "cumsum":
        return -(-_prod(out_chunk) // out_chunk[m.attrs["dim"]] * reps // threads)
    if m.opcode == "dot":
        if tiling is not None:
            return _dot_tiles(m, sched, tiling) * reps
        rm, rn = _reg_tile(out_chunk[-2], out_chunk[-1])
        return -(-_prod(out_chunk) // (rm * rn) * reps // threads)
    return -(-_prod(out_chunk) * reps // threads)


def _phase_launch(members: Sequence[Instruction], solution: ScheduleSolution, plan, written,
                  held: FrozenSet[int], tiles: Dict[int, int], threads: int, part: int,
                  grouped: bool) -> PhaseLaunch:
    """One phase's ``PhaseLaunch`` at ``threads`` a block.  ``written``:
    the members it writes to outputs or staged interfaces; ``held`` and
    ``tiles``: ``_stored_tiles``; ``part``: the shared memory the kernel
    keeps beside the slots; ``grouped``: a single-phase kernel, whose
    independent member groups take CUDA blocks of their own.  Its slots sit
    in shared memory where they fit beside ``part``, a staged dot's operand
    tiles after them."""
    offsets, size = _slot_layout(plan, set(tiles.values())) if plan is not None else ({}, 0)
    slots_in = None
    if tiles:
        slots_in = SHARED if size + part <= SMEM_LIMIT else WORKSPACE
    dot_offset = -(-size // SLOT_ALIGN) * SLOT_ALIGN if slots_in == SHARED else 0
    composed = {m.id for m in members} - set(tiles)
    budget = SMEM_LIMIT - dot_offset - reduce_part_bytes(threads)
    tilings = {m.id: staged_dot_tiling(m, solution.assignment[m.id], threads, budget, composed)
               for m in members if m.opcode == "dot"}
    blocks = max(1, solution.blocks)
    stored = [m for m in members if m.id in tiles or m.id in written]
    groups = None
    if tiles and grouped:
        ids = {m.id for m in stored}
        groups = tuple(tuple(g) for g in _independent_groups(members) if ids & set(g))
        grid = blocks * len(groups)
    elif tiles:
        grid = blocks
    else:
        grid = max([1] + [_map_loop_grid(m, solution.assignment[m.id], blocks, threads,
                                         tilings.get(m.id)) for m in stored])
    return PhaseLaunch(grid, threads, held, tiles, offsets, size, slots_in, dot_offset, tilings,
                       groups)


def fusion_launch(members: Sequence[Instruction], roots: Sequence[Instruction],
                  solution: ScheduleSolution, plan: Optional[MemoryPlan] = None) -> PhaseLaunch:
    """The launch ``emit_fusion`` makes for this plan: plan blocks x
    independent member groups where a member keeps a slot, else the pure
    map's grid, of the fewest threads, from 128 up to 512, that leave every
    loop of a plan block (each member that writes a slot or an output; a
    member held in a register writes neither) at most
    ``STITCHED_ELEMS_PER_THREAD`` elements, or a reduce's terms, a thread,
    and give every reduce output a warp.  Without a memory plan, a reduce,
    dot or running sum read inside the fusion is taken to keep its slot."""
    root_ids = {r.id for r in roots}
    held, tiles = _stored_tiles(members, solution, plan, root_ids)
    want = 1
    for m in members:
        if m.opcode == "constant" or not (m.id in root_ids or m.id in tiles):
            continue
        sched = solution.assignment[m.id]
        n = _prod(chunk_shape(m.shape, sched))
        if m.opcode == "reduce":
            (ns,) = propagate(m, sched, True)
            terms = _prod(chunk_shape(m.operands[0].shape, ns))
            want = max(want, 32 * n, -(-terms // STITCHED_ELEMS_PER_THREAD))
        elif m.opcode == "cumsum":
            want = max(want, n // chunk_shape(m.shape, sched)[m.attrs["dim"]])
        else:
            want = max(want, -(-n // STITCHED_ELEMS_PER_THREAD))
    threads = _threads_for(want)
    (launch,) = _blocks_per_sm([_phase_launch(members, solution, plan, root_ids, held, tiles,
                                              threads, reduce_part_bytes(threads), True)], members)
    return launch


def stitched_launch(stitched: StitchedSolution, plan: Optional[StitchedMemoryPlan] = None
                    ) -> Tuple[PhaseLaunch, ...]:
    """Each phase's launch in ``emit_stitched_fusion``'s cooperative launch:
    a phase's plan blocks where a member keeps a slot, else its pure map's
    grid, at ``stitched_threads`` a block (512 without a plan); a phase's
    slots in shared memory where they fit, the reduce partials apart."""
    group_ids = {m.id for p in stitched.phases for m in p.members}
    staged = {i.id for i in stitched.interfaces}
    threads = stitched_threads(plan) if plan is not None else STITCHED_MAX_THREADS
    out = []
    for k, p in enumerate(stitched.phases):
        written = {m.id for m in p.members
                   if m.id in staged or not m.users or any(u.id not in group_ids for u in m.users)}
        pplan = plan.phase_plans[k] if plan is not None else None
        held, tiles = _stored_tiles(p.members, p.solution, pplan, written)
        out.append(_phase_launch(p.members, p.solution, pplan, written, held, tiles, threads, 0,
                                 False))
    return _blocks_per_sm(out, [m for p in stitched.phases for m in p.members])
