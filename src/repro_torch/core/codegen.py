"""IrEmitterStitched for Hopper — the port of ``repro/core/codegen.py``.

The reference emits one Pallas kernel per fused computation.  Here the two
generators write CUDA C++ instead, and every kernel keeps a plain PyTorch
version beside it:

  * ``emit_fusion`` replaces ``repro/core/codegen.py:emit_fusion`` (its
    ``pl.pallas_call`` at line 234).  Each grid program of the fusion's
    ``ScheduleSolution`` (a plan block) runs on one CUDA block, or on one
    per group of members that share no value; the schedule's block-index
    arithmetic (``schedule.block_index``) is printed into the source with
    the shapes baked in as constants.  Chunks divide exactly, so nothing
    is masked.
  * ``emit_stitched_fusion`` replaces ``emit_stitched_fusion`` (its
    ``pl.pallas_call`` at line 376).  Still ONE launch per stitched group,
    the paper's point, but not the reference's one program (``grid=(1,)``):
    one cooperative launch (``cudaLaunchCooperativeKernel``) of as many
    blocks as the card holds at once, at most as many as the work can use,
    the count asked once per device.  A grid barrier (``sx_grid_sync``,
    ``cooperative_groups::this_grid().sync()``) separates the phases.  The
    reference's ``StitchedMemoryPlan`` is the memory plan: a phase's
    ALLOC/SHARE members live in its slots, in the block's dynamic shared
    memory where the phase's slots fit (past 48 KB after
    ``cudaFuncSetAttribute``; phases run one after another, so they share
    it), else in a per-block region of the global workspace; INLINE members
    are composed into their consumers' expressions per thread and write no
    tile.  A phase with slots deals its plan blocks over the grid, one
    plan block to a CUDA block at a time; a phase with no slot is a pure
    map whose elements stride over the whole grid (in the order of each
    member's output: see "Thread order" below).  Reduces are
    cooperative: a warp per output element, shuffles to combine (the
    whole block where a plan block has fewer outputs than warps).
    Interface tensors are staged whole in the global workspace —
    StitchPipe's alone is 655,360 bytes, more than one block's 227 KB of
    shared memory — and re-tiled by their consumer phases.

Design of ``emit_fusion``: one launch of the same phase emitter
(``_Phase``) the stitched kernel runs each phase through, over the
fusion's ``MemoryPlan``.  ALLOC/SHARE members live in the plan's slots, in
dynamic shared memory at the slots' offsets (past ``geometry.SMEM_LIMIT``, in a
per-block region of the workspace); INLINE members are composed into their
consumers and write nothing; outputs are written straight to ``out*``.  A
plan block's members run in order, each a fixed-count unrolled loop over
its tile with a barrier after it.  Members that share no value form groups
(``geometry._independent_groups``), and each (plan block, group) pair runs on a
CUDA block of its own: ReduceTowers' six towers on six SMs.  A reduce
takes a warp per output, or, where a plan block has fewer outputs than
warps, the whole block, partial results combined through shared memory.
A fused dot is staged (``_Phase.staged_dot_loop``): a block computes BM x BN
tiles of its output chunk, each thread a register tile of up to 8 x 4 of
one, and walks k in steps of BK, its threads staging the two operands'
k-blocks in shared memory after the slots (the next step's values held in
registers meanwhile), each value (a composed operand computed) read once
and along its source's contiguous dimension; f32 FMAs in the reference's
order of k (no TF32), so the outputs are the register-tile loop's bit for
bit.  A dot whose operands are both bf16, or both f16, runs on the tensor
cores instead (``_Phase.mma_dot_loop``: ``mma.sync`` m16n8k16, f32 sums;
``DotTiling.warps``), the two loops sharing the staging (``_DotStaging``): its
operands are staged in their own type, k-major where their source is
contiguous along k, and read by ``ldmatrix``; its products are exact in
f32, so only the order of its sums differs.  Where the staging does not
fit beside the slots, the dot keeps the register-tile loop: each thread
reads its operands where they are.  The header names the loop each dot
took, and the tracer counts the dots on the tensor cores
(``codegen.mma_dots``).  A fusion with no slot
is a pure map over the grid.  Threads per block follow the plan
(``geometry.fusion_launch``: 128 to 512).

Thread order of a pure map: its loop over a member's elements gives
consecutive threads consecutive ``t``.  Where the member's chunk is one
contiguous span of its output, ``t`` runs over the plan blocks' chunks in
turn (``b = t / n``, ``i = t % n``), which is the output's own order.  Where
it is not (a dimension chunked and a later one not whole, as the causal
mask broadcast to (4, 24, 4096, 4096) on a ``[4, 24, 4096, 1]`` tile), that
order put a warp's stores 4096 elements apart, one 32-byte sector each, so
the loop walks the output in its row-major order instead
(``_Phase._ordered_head``): ``t`` is unravelled over the output, each
dimension's chunk index and index in the chunk come from it, and ``b`` is
formed from the chunk indices as ``schedule.block_index`` numbers plan
blocks.  Every element is the same expression of the same plan block's
values, so the outputs do not change.  The tracer counts both kinds of loop
(``codegen.map_loops``, ``codegen.map_loops_reordered``).

Who decides what: the launch of each kernel, and of each phase of a
stitched one, is ``core/geometry.py``'s ``PhaseLaunch`` (grid, threads, the
members that write a slot and the slots' offsets, where the slots live, the
members held in a register, the independent member groups, where a staged
dot's operand tiles start, each dot's loop).  The planner's cost model
(``core/latency.py``) charges a plan by the same record, so what it prices
is what runs.  ``emit_fusion`` and ``emit_stitched_fusion`` take it from
``geometry.fusion_launch`` and ``geometry.stitched_launch`` and hand it to
``_cuda_fusion`` and ``_cuda_stitched``, whose ``_Phase`` writes it out; the
text decides only the index width (``_wide``).  This module
imports ``geometry``, ``memory``, ``schedule``, ``fusion`` and ``ir``; no
planner module imports it.

Indices are ``int`` unless a tensor a kernel addresses, or a loop it runs,
passes 2^31 - 1 elements: then every loop variable, block index and
offset of the kernel is ``long long`` (``_wide``; the header says so), and
a launch past 2^31 - 1 blocks raises ``NotImplementedError``.

What bounds these kernels on the H100: an elementwise fusion is bound by
the bytes it reads and writes (the card's 3.35 TB/s), a small one by the
launch and by the dependent loads and barriers between members.  A slot
that buys nothing costs both: bf16 ``F.silu(a) * b`` reads the f32 convert
of ``a`` twice, so the plan gives it an ALLOC slot of 442,368 bytes a plan
block at (512, 3456), past what a block's shared memory holds; the kernel
then ran one CUDA block per plan block (16 of 512 threads) and sent every
element through the workspace and back: 153-158 device µs on an H100
against a bound of 3.2.  So a member that every reader reads at the element it would
write, and that reads every slot it reads at that element too, is held in
a register (``geometry.held_in_registers``): each loop that reads it computes it
once per element into a ``const`` of its compute type, with the same
operations and roundings, and a phase that keeps no slot is the pure map
over the grid (3456 blocks of 512 threads there, no workspace).  The plan
itself, and what the reference reports of it, is unchanged.

Every member computes in ``float`` (bf16, f16) or ``int`` (int8, uint8, int16)
where it is stored narrower and is rounded, or wrapped, to its dtype where
it ends, composed or not, as the reference's per-instruction ``apply_op``
does; a reduce over bf16 accumulates in float and rounds once.  Scalar
constants are exact literals: hex floats, bf16 and f16 by their bits.

The plain version of each kernel is a block interpreter over the port's
``apply_op``: ``for b in range(blocks)`` evaluates every member on its tile,
as Pallas ``interpret=True`` does.  A kernel wrapper takes it only for CPU
tensors; for CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import math
import re
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import tracing
from .device import input_device, resolve_device
from .fusion import FusedComputation
from .geometry import (
    SHARED,
    STATIC_SMEM_LIMIT,
    WORKSPACE,
    DotTiling,
    PhaseLaunch,
    _c_compute,
    _c_types,
    _reg_tile,
    dot_prefetch,
    fusion_launch,
    minor_moved,
    reduce_part_bytes,
    staged_itemsize,
    stitched_launch,
)
from .ir import (
    BFLOAT16,
    Instruction,
    _prod,
    apply_op,
    as_array,
    broadcast_in_dim,
    iota,
    sliced_dims,
    torch_dtype,
)
from .memory import SLOT_ALIGN, MemoryPlan, StitchedMemoryPlan
from .schedule import (
    REPLICATED,
    ROW,
    Sched,
    PhaseSolution,
    ScheduleSolution,
    StitchedSolution,
    block_index,
    chunk_shape,
    propagate,
)

#: the TPU kernel each generator replaces (the reference's pallas_call line)
REPLACES = {
    "emit_fusion": "src/repro/core/codegen.py:234",
    "emit_stitched_fusion": "src/repro/core/codegen.py:376",
}

GRID_CACHE_DEVICES = 16   # devices whose cooperative grid a launcher caches
#: the largest index a kernel forms in ``int``; past it, in ``long long``
INT_MAX = 2 ** 31 - 1


def _starts(shape, sched: Sched, b):
    idx = block_index(tuple(shape), sched, b)
    cs = chunk_shape(tuple(shape), sched)
    return tuple(i * c for i, c in zip(idx, cs, strict=False))


def _check_no_collectives(fusion: FusedComputation) -> None:
    for m in fusion.members:
        if m.is_collective:
            raise ValueError(
                f"{m.name}: collective {m.opcode} cannot be emitted inside "
                "a kernel; it must stay a standalone schedule break"
            )


# --------------------------------------------------------------------------
# Plain versions: the per-block program in torch (Pallas interpret analogue)
# --------------------------------------------------------------------------


def _window(shape, sched: Sched, b) -> Tuple[slice, ...]:
    starts = _starts(shape, sched, b)
    cs = chunk_shape(tuple(shape), sched)
    return tuple(slice(s, s + c) for s, c in zip(starts, cs, strict=False))


def _adapt(val, opnd: Instruction, stored: Sched, needed: Sched, b):
    """Convert an operand's stored form to the consumer's needed form."""
    if stored == needed:
        return val
    if stored.kind == "replicated" and needed.kind == "chunked":
        return val[_window(opnd.shape, needed, b)]
    raise AssertionError(
        f"cannot adapt {opnd.name}: stored {stored}, needed {needed}"
    )


def _emit_instr(instr: Instruction, sched: Sched, ovals: List, b, device):
    """Evaluate one instruction on block tiles (thread-composition body)."""
    op = instr.opcode
    a = instr.attrs
    out_chunk = chunk_shape(instr.shape, sched)

    if op in ("reshape", "bitcast"):
        return torch.reshape(ovals[0], out_chunk)

    if op == "broadcast":
        dims = tuple(a["dims"])
        opnd = instr.operands[0]
        v = ovals[0]
        if sched.kind == "chunked" and tuple(v.shape) == tuple(opnd.shape):
            # replicated operand feeding a chunked broadcast: slice the
            # operand window this block's output chunk maps onto
            ost = _starts(instr.shape, sched, b)
            v = v[tuple(
                slice(ost[dims[j]], ost[dims[j]] + out_chunk[dims[j]])
                if opnd.shape[j] != 1 else slice(0, 1)
                for j in range(len(dims))
            )]
        return broadcast_in_dim(v, out_chunk, dims)

    if op == "iota":
        base = iota(out_chunk, a["dim"], instr.dtype, device)
        if sched.kind == "chunked":
            base = base + _starts(instr.shape, sched, b)[a["dim"]]
        return base.to(torch_dtype(instr.dtype))

    if op == "dot" and sched.kind == "chunked":
        # a row split's rhs is read whole: this block's output batch of it
        nb = len(out_chunk) - 2
        lhs, rhs = ovals
        if tuple(rhs.shape[:nb]) != tuple(out_chunk[:nb]):
            rhs = rhs[_window(instr.shape, sched, b)[:nb]]
        return apply_op(instr, lhs, rhs, device=device)

    return apply_op(instr, *ovals, device=device)


def _store_chunk(out: torch.Tensor, instr: Instruction, sched: Sched, v, b) -> None:
    """Write one block's value into a full-shape tensor at its offsets."""
    if sched.kind == "replicated" or not instr.shape:
        out[...] = v
        return
    out[_window(instr.shape, sched, b)] = v


def _empty_like_instr(instr: Instruction, device) -> torch.Tensor:
    return torch.empty(tuple(instr.shape), dtype=torch_dtype(instr.dtype), device=device)


def _plain_fusion(fusion: FusedComputation, solution: ScheduleSolution) -> Callable:
    members, inputs, roots = fusion.members, fusion.inputs, fusion.roots
    assign = solution.assignment
    root_pos = {r.id: j for j, r in enumerate(roots)}

    def run(*args, device):
        outs = [_empty_like_instr(r, device) for r in roots]
        for b in range(solution.blocks):
            vals: Dict[int, object] = {}
            stored: Dict[int, Sched] = {}
            for instr, arg in zip(inputs, args, strict=True):
                s = assign.get(instr.id, REPLICATED)
                vals[instr.id] = arg if s.kind == "replicated" else arg[_window(instr.shape, s, b)]
                stored[instr.id] = s
            for m in members:
                sched = assign[m.id]
                if m.opcode == "constant":
                    vals[m.id] = apply_op(m, device=device)
                    stored[m.id] = REPLICATED
                else:
                    ovals = [
                        _adapt(vals[o.id], o, stored[o.id], ns, b)
                        for o, ns in zip(m.operands, propagate(m, sched, True), strict=False)
                    ]
                    vals[m.id] = _emit_instr(m, sched, ovals, b, device)
                    stored[m.id] = sched
                if m.id in root_pos:
                    _store_chunk(outs[root_pos[m.id]], m, stored[m.id], vals[m.id], b)
        return tuple(outs)

    return run


def _plain_stitched(fusion: FusedComputation, stitched: StitchedSolution,
                    plan: StitchedMemoryPlan) -> Callable:
    inputs, roots = fusion.inputs, fusion.roots
    root_pos = {r.id: j for j, r in enumerate(roots)}
    members = {m.id: m for m in fusion.members}

    def run(*args, device):
        outs = [_empty_like_instr(r, device) for r in roots]
        staged = {iid: _empty_like_instr(members[iid], device) for iid in plan.interfaces}
        global_vals: Dict[int, object] = {
            instr.id: arg for instr, arg in zip(inputs, args, strict=True)
        }
        for pk, phase in enumerate(stitched.phases):
            assign = phase.solution.assignment
            # staged interfaces this phase consumes, read whole — only once
            # their producer phase has fully run
            for m in phase.members:
                for o in m.operands:
                    if (
                        o.id in staged
                        and o.id not in global_vals
                        and plan.interfaces[o.id].produced_phase < pk
                    ):
                        global_vals[o.id] = staged[o.id]
            for b in range(phase.solution.blocks):
                vals: Dict[int, object] = {}
                stored: Dict[int, Sched] = {}
                for m in phase.members:
                    sched = assign[m.id]
                    if m.opcode == "constant":
                        v = apply_op(m, device=device)
                        sched = REPLICATED
                    else:
                        ovals = []
                        for o, ns in zip(m.operands, propagate(m, sched, True), strict=False):
                            if o.id in vals:
                                ovals.append(_adapt(vals[o.id], o, stored[o.id], ns, b))
                            else:  # kernel input or staged interface: whole
                                ovals.append(_adapt(global_vals[o.id], o, REPLICATED, ns, b))
                        v = _emit_instr(m, sched, ovals, b, device)
                    vals[m.id] = v
                    stored[m.id] = sched
                    if m.id in staged:
                        _store_chunk(staged[m.id], m, sched, v, b)
                    if m.id in root_pos:
                        _store_chunk(outs[root_pos[m.id]], m, sched, v, b)
        return tuple(outs)

    return run


# --------------------------------------------------------------------------
# CUDA C++ generation
# --------------------------------------------------------------------------

# storage -> compute, and compute -> storage (rounding to nearest even)
_C_LOAD = {"__half": "__half2float({})", "__nv_bfloat16": "__bfloat162float({})",
           "signed char": "static_cast<int>({})", "unsigned char": "static_cast<int>({})",
           "short": "static_cast<int>({})"}
_C_STORE = {"__half": "__float2half_rn({})", "__nv_bfloat16": "__float2bfloat16_rn({})",
            "signed char": "static_cast<signed char>({})",
            "unsigned char": "static_cast<unsigned char>({})",
            "short": "static_cast<short>({})"}

_INFIX = {
    "add": "+", "sub": "-", "mul": "*", "div": "/",
    "lt": "<", "le": "<=", "gt": ">", "ge": ">=", "eq": "==", "ne": "!=",
    "and": "&&", "or": "||",
}


def _c_type(dtype) -> str:
    """The C type of a ``dtype`` value in memory."""
    return _c_types(dtype)[0]


def _c_load(dtype, x: str) -> str:
    """``x``, a value as stored, in the type it is computed in."""
    return _C_LOAD.get(_c_type(dtype), "{}").format(x)


def _c_store(dtype, x: str) -> str:
    """``x``, a computed value, in the type it is stored in."""
    return _C_STORE.get(_c_type(dtype), "{}").format(x)


def _c_round(dtype, x: str) -> str:
    """``x`` rounded (or wrapped) to ``dtype``, in the type it is computed in."""
    return x if _c_type(dtype) not in _C_STORE else _c_load(dtype, _c_store(dtype, x))


def _c_literal(value, dtype) -> str:
    """An exact C++ literal of one scalar, in the type it is stored in: hex
    floats carry every bit, bf16 and f16 are built from their bits."""
    dt = np.dtype(dtype)
    if dt == BFLOAT16 or dt == np.float16:
        bits = (torch.as_tensor(as_array(value, dt), dtype=torch_dtype(dt)).reshape(())
                .view(torch.int16).item() & 0xFFFF)
        fn = "__ushort_as_bfloat16" if dt == BFLOAT16 else "__ushort_as_half"
        return f"{fn}(static_cast<unsigned short>(0x{bits:04x}))"
    v = np.asarray(value, dtype=dt).reshape(())
    if dt == np.int8 or dt == np.uint8 or dt == np.int16:
        return f"static_cast<{_c_type(dt)}>({int(v)})"
    if dt == np.float32 or dt == np.float64:
        f = float(v)
        if math.isfinite(f):
            return f"({f.hex()}{'f' if dt == np.float32 else ''})"
        if dt == np.float32:
            return f"__int_as_float(0x{int(v.view(np.uint32)):08x})"
        return f"__longlong_as_double(0x{int(v.view(np.uint64)):016x}ULL)"
    if dt == np.bool_:
        return "true" if bool(v) else "false"
    i = int(v)
    if dt == np.int32:
        return "(-2147483647 - 1)" if i == -(2 ** 31) else f"({i})"
    if dt == np.int64:
        return "(-9223372036854775807LL - 1)" if i == -(2 ** 63) else f"({i}LL)"
    raise NotImplementedError(f"no C literal for dtype {dt}")


class _Sym:
    """A C integer expression that ``schedule.block_index`` can compute on
    (it only uses //, % and *), so the reference's own block arithmetic is
    printed into the kernel instead of being re-derived."""

    __slots__ = ("expr",)

    def __init__(self, expr: str):
        self.expr = expr

    def __mod__(self, n):
        return 0 if n == 1 else _Sym(f"({self.expr} % {n})")

    def __floordiv__(self, n):
        return self if n == 1 else _Sym(f"({self.expr} / {n})")

    def __mul__(self, n):
        if n == 0:
            return 0
        return self if n == 1 else _Sym(f"({self.expr} * {n})")

    __rmul__ = __mul__


def _c_starts(shape, sched: Sched, b) -> Tuple:
    """Chunk start offsets as ints or C expressions of the block index."""
    if sched.kind == "replicated":
        return (0,) * len(shape)
    return tuple(s.expr if isinstance(s, _Sym) else s for s in _starts(shape, sched, b))


def _contiguous(shape, chunk) -> bool:
    """Whether a chunk of ``shape`` is one contiguous span of it: every
    dimension past its first longer than one is whole."""
    longer = [d for d, c in enumerate(chunk) if c != 1]
    return not longer or tuple(chunk[longer[0] + 1:]) == tuple(shape[longer[0] + 1:])


def _block_of(shape, sched: Sched, q) -> str:
    """The plan block whose chunk holds block-unit index ``q`` (ints or C
    expressions): ``schedule.block_index`` inverted."""
    s, w = sched.split_dim, sched.sword
    if sched.sched_type == ROW:
        return _lin(q[:s + 1], tuple(shape[:s]) + (w,))
    return _lin(q[s:], (w,) + tuple(shape[s + 1:]))


def _cadd(a, b):
    if isinstance(a, int) and isinstance(b, int):
        return a + b
    if isinstance(a, int) and a == 0:
        return b
    if isinstance(b, int) and b == 0:
        return a
    return f"({a} + {b})"


def _cmul(a, c: int):
    if isinstance(a, int):
        return a * c
    return a if c == 1 else f"{a} * {c}"


def _dense_strides(shape) -> Tuple[int, ...]:
    out, acc = [], 1
    for s in reversed(tuple(shape)):
        out.append(acc)
        acc *= int(s)
    return tuple(reversed(out))


@dataclass
class _View:
    """How a consumer reads one operand: element ``idx`` of the tile it
    needs is ``ptr[sum((offs[k] + idx[k]) * strides[k])]``, or ``literal``
    (as stored), a ``dtype`` value read in the type it is computed in."""

    shape: Tuple[int, ...]
    ptr: str = ""
    strides: Tuple[int, ...] = ()
    offs: Tuple = ()
    literal: str = ""
    dtype: object = np.float32
    wide: bool = False      # offsets past INT_MAX: each product formed in 64 bits

    def at(self, idx) -> str:
        return _c_load(self.dtype, self.stored_at(idx))

    def stored_at(self, idx) -> str:
        """The element in the type it is stored in, not widened."""
        return self.literal or self.ref(idx)

    def ref(self, idx) -> str:
        """The element itself, as stored: what a write assigns to."""
        ints, parts = 0, []
        for o, j, s in zip(self.offs, idx, self.strides, strict=True):
            t = _cadd(o, j)
            t = _cmul(f"static_cast<long long>({t})" if self.wide and s != 1 and not isinstance(t, int)
                      else t, s)
            if isinstance(t, int):
                ints += t
            else:
                parts.append(t)
        if ints or not parts:
            parts.append(str(ints))
        return f"{self.ptr}[{' + '.join(parts)}]"


def _unravel(lines: List[str], var: str, shape, prefix: str, ind: str, itype: str) -> List:
    """Emit statements splitting linear index ``var`` over ``shape``, in
    integers of C type ``itype``."""
    idx: List = [0] * len(shape)
    dims = [k for k, s in enumerate(shape) if s != 1]
    if not dims:
        return idx
    rem = f"{prefix}_rem"
    lines.append(f"{ind}{itype} {rem} = {var};")
    for k in reversed(dims):
        name = f"{prefix}{k}"
        if k == dims[0]:
            lines.append(f"{ind}const {itype} {name} = {rem};")
        else:
            lines.append(f"{ind}const {itype} {name} = {rem} % {shape[k]}; {rem} /= {shape[k]};")
        idx[k] = name
    return idx


def _unravel_wide(lines: List[str], var: str, shape, prefix: str, ind: str) -> List:
    """``_unravel`` of a linear index that passes INT_MAX: its remainder is
    a ``long long`` while the quotient left may pass INT_MAX, then an
    ``int`` (a 64-bit division costs several 32-bit ones); each index is
    an ``int``, under its dimension's extent."""
    idx: List = [0] * len(shape)
    dims = [k for k, s in enumerate(shape) if s != 1]
    rem = f"{prefix}_rem"
    lines.append(f"{ind}long long {rem} = {var};")
    for k in reversed(dims):
        if rem == f"{prefix}_rem" and _prod(shape[:k + 1]) - 1 <= INT_MAX:
            lines.append(f"{ind}int {prefix}_rem32 = static_cast<int>({rem});")
            rem = f"{prefix}_rem32"
        name = f"{prefix}{k}"
        if k == dims[0]:
            lines.append(f"{ind}const int {name} = {rem};")
        else:
            lines.append(f"{ind}const int {name} = {rem} % {shape[k]}; {rem} /= {shape[k]};")
        idx[k] = name
    return idx


# a reduce's accumulator: its start, each step, and the warp shuffle's
# combine of two partial results (stitch_runtime.cuh), in the type the
# reduce computes in ({T})
_REDUCE_INIT = {"sum": "static_cast<{T}>(0)", "mean": "static_cast<{T}>(0)",
                "prod": "static_cast<{T}>(1)", "max": "sx_lowest<{T}>()",
                "min": "sx_highest<{T}>()"}
_REDUCE_STEP = {"sum": "acc += {x};", "mean": "acc += {x};", "prod": "acc *= {x};",
                "max": "acc = sx_max(acc, {x});", "min": "acc = sx_min(acc, {x});"}
_REDUCE_COMBINE = {"sum": "SxRedSum", "mean": "SxRedSum", "prod": "SxRedProd",
                   "max": "SxRedMax", "min": "SxRedMin"}


def _value(m: Instruction, sched: Sched, ovs: List[_View], idx: List, b,
           lines: List[str], ind: str, itype: str, lin: str = "i", sfx: str = "") -> str:
    """Emit the statements computing element ``idx`` of ``m``'s tile and
    return the C expression of its value, in the type ``m`` computes in and
    not yet rounded to ``m.dtype`` (the reference's ``_emit_instr`` and
    ``apply_op``, per element; reduces, dots and running sums have loops
    of their own).  ``itype`` is the C type of the phase's indices.
    ``lin`` is the linear index of ``idx`` in the tile, and ``sfx`` keeps
    the names of the statements' variables apart where several values are
    composed into one expression."""
    op, a = m.opcode, m.attrs
    T = _c_compute(m.dtype)
    out_chunk = chunk_shape(m.shape, sched)
    if op == "constant":
        return _c_load(m.dtype, _c_literal(a["value"], m.dtype))
    if op == "elementwise":
        fn = a["fn"]
        x = ovs[0].at(idx)
        if fn == "convert":
            if _c_compute(m.operands[0].dtype) in ("float", "double") and T in ("int", "long long"):
                # jnp's float -> int: truncation, NaN gives 0, the rest saturates
                return _c_load(m.dtype, f"sx_f2i<{_c_type(m.dtype)}>({x})")
            return f"static_cast<{T}>({x})"
        if fn == "not":
            return f"(!{x})"
        if len(ovs) == 1:
            return f"sx_{fn}({x})"
        y = ovs[1].at(idx)
        if fn in _INFIX:
            return f"({x} {_INFIX[fn]} {y})"
        return f"sx_{fn}({x}, {y})"
    if op == "select":
        return f"({ovs[0].at(idx)} ? {ovs[1].at(idx)} : {ovs[2].at(idx)})"
    if op in ("reshape", "bitcast"):
        # ``lin`` runs over the operand's tile: past INT_MAX it is split in
        # 64 bits until the quotient left fits an ``int`` (``_unravel_wide``)
        if itype != "int" and _prod(ovs[0].shape) - 1 > INT_MAX:
            j = _unravel_wide(lines, lin, ovs[0].shape, f"p{sfx}", ind)
        else:
            j = _unravel(lines, lin, ovs[0].shape, f"p{sfx}", ind, "int")
        return ovs[0].at(j)
    if op == "slice":
        # an offset index: the operand's tile holds each sliced dim whole
        j = list(idx)
        for d in sliced_dims(m):
            j[d] = _cadd(a["starts"][d], _cmul(idx[d], a["strides"][d]))
        return ovs[0].at(j)
    if op == "transpose":
        j: List = [0] * len(idx)
        for k, p in enumerate(a["perm"]):
            j[p] = idx[k]
        return ovs[0].at(j)
    if op == "broadcast":
        dims = tuple(a["dims"])
        opnd = m.operands[0]
        v = ovs[0]
        if sched.kind == "chunked" and tuple(v.shape) == tuple(opnd.shape):
            # replicated operand under a chunked broadcast: read the window
            # this block's output chunk maps onto (reference ``_emit_instr``)
            ost = _c_starts(m.shape, sched, b)
            j = [0 if opnd.shape[k] == 1 else _cadd(ost[d], idx[d]) for k, d in enumerate(dims)]
        else:
            j = []
            for k, d in enumerate(dims):
                if v.shape[k] != 1 and v.shape[k] != out_chunk[d]:
                    raise ValueError(f"{m.name}: operand tile {v.shape} cannot broadcast to {out_chunk}")
                j.append(0 if v.shape[k] == 1 else idx[d])
        return v.at(j)
    if op == "iota":
        d = a["dim"]
        off = _c_starts(m.shape, sched, b)[d] if sched.kind == "chunked" else 0
        return f"static_cast<{T}>({_cadd(off, idx[d])})"
    if op == "concat":
        d = a["dim"]
        edges = [0]
        for v in ovs:
            edges.append(edges[-1] + v.shape[d])

        def piece(k):
            j = list(idx)
            j[d] = idx[d] - edges[k] if isinstance(idx[d], int) else (
                f"({idx[d]} - {edges[k]})" if edges[k] else idx[d]
            )
            return ovs[k].at(j)

        if isinstance(idx[d], int):
            k = next(k for k in range(len(ovs)) if idx[d] < edges[k + 1])
            return piece(k)
        # each piece's statements (a composed reshape's index arithmetic, a
        # gather's index load) run only on the branch that takes the piece:
        # elsewhere its index is out of its range.  A piece is never a
        # cooperative reduce (a reduce with a user reads its slot), so no
        # branch holds a shuffle or a barrier.
        exprs, stmts = [], []
        for k in range(len(ovs)):
            before = len(lines)
            exprs.append(piece(k))
            stmts.append(lines[before:])
            del lines[before:]
        if not any(stmts):
            expr = exprs[-1]
            for k in range(len(ovs) - 2, -1, -1):
                expr = f"({idx[d]} < {edges[k + 1]} ? {exprs[k]} : {expr})"
            return expr
        var = f"cat{sfx}"
        lines.append(f"{ind}{T} {var};")
        for k in range(len(ovs)):
            head = "if" if k == 0 else "} else if"
            lines.append(f"{ind}{head} ({idx[d]} < {edges[k + 1]}) {{" if k < len(ovs) - 1
                         else f"{ind}}} else {{")
            lines += ["  " + line for line in stmts[k]]
            lines.append(f"{ind}  {var} = {exprs[k]};")
        lines.append(f"{ind}}}")
        return var
    if op == "gather":
        table, ind_view = ovs
        r = len(ind_view.shape)
        n = m.operands[0].shape[0]
        # jnp.take's default "fill" mode: [-n, n) wraps, the rest fills
        g, ok = f"g{sfx}", f"ok{sfx}"
        lines.append(f"{ind}long long {g} = static_cast<long long>({ind_view.at(idx[:r])});")
        lines.append(f"{ind}const bool {ok} = {g} >= -{n}LL && {g} < {n}LL;")
        lines.append(f"{ind}if ({g} < 0) {g} += {n}LL;")
        fill = _c_load(m.dtype, f"sx_fill<{_c_type(m.dtype)}>()")
        return f"({ok} ? {table.at([g] + list(idx[r:]))} : {fill})"
    raise NotImplementedError(f"{m.name}: no CUDA emission for opcode {op!r}")


def _tile_view(name: str, shape, stored: Sched, needed: Sched, opnd: Instruction, b,
               full: bool, wide: bool = False) -> _View:
    """The reference's ``_adapt`` as a view: ``full`` arrays (kernel inputs,
    staged interfaces) hold the whole tensor; tiles hold the stored chunk."""
    dt = opnd.dtype
    if stored == needed:
        if full and stored.kind == "chunked":
            return _View(chunk_shape(opnd.shape, stored), name, _dense_strides(opnd.shape),
                         _c_starts(opnd.shape, stored, b), dtype=dt, wide=wide)
        return _View(tuple(shape), name, _dense_strides(shape), (0,) * len(shape), dtype=dt,
                     wide=wide)
    if stored.kind == "replicated" and needed.kind == "chunked":
        return _View(chunk_shape(opnd.shape, needed), name, _dense_strides(opnd.shape),
                     _c_starts(opnd.shape, needed, b), dtype=dt, wide=wide)
    raise ValueError(f"cannot adapt {opnd.name}: stored {stored}, needed {needed}")


def _literal_view(m: Instruction, needed: Sched) -> _View:
    return _View(chunk_shape(m.shape, needed), literal=_c_literal(m.attrs["value"], m.dtype),
                 dtype=m.dtype)


class _Workspace:
    """Byte offsets of the arrays a kernel keeps in its global workspace."""

    def __init__(self):
        self.size = 0
        self.decls: List[str] = []

    def alloc(self, name: str, instr: Instruction, shape, base: str, ind: str) -> str:
        off = self.size
        self.size += -(-_prod(shape) * np.dtype(instr.dtype).itemsize // SLOT_ALIGN) * SLOT_ALIGN
        self.decls.append(
            f"{ind}{_c_type(instr.dtype)}* const {name} = "
            f"reinterpret_cast<{_c_type(instr.dtype)}*>({base} + {off});"
        )
        return name


def _signature_c(inputs, roots, ws_restrict: bool = True) -> Tuple[List[str], List[str], List[str]]:
    params, lparams, casts = [], [], []
    for k, i in enumerate(inputs):
        T = _c_type(i.dtype)
        params.append(f"const {T}* __restrict__ in{k}")
        lparams.append(f"const void* in{k}")
        casts.append(f"static_cast<const {T}*>(in{k})")
    for k, r in enumerate(roots):
        T = _c_type(r.dtype)
        params.append(f"{T}* __restrict__ out{k}")
        lparams.append(f"void* out{k}")
        casts.append(f"static_cast<{T}*>(out{k})")
    # a stitched kernel reads back what its earlier phases wrote to ws
    params.append("unsigned char* __restrict__ ws" if ws_restrict else "unsigned char* ws")
    lparams.append("void* ws")
    casts.append("static_cast<unsigned char*>(ws)")
    return params, lparams, casts


#: characters of a kernel symbol's fusion label (``fusion_label``)
LABEL_CHARS = 32
#: each kernel name's symbol, as first labelled: one text, one symbol
_SYMBOLS: Dict[str, str] = {}


def fusion_label(members: Sequence[Instruction]) -> str:
    """What a generated kernel's symbol says of its fusion: the distinct ops
    of its members in program order (an elementwise member's function, a
    reduce's kind, else the opcode), joined by ``_`` in ``LABEL_CHARS``
    characters of ``[a-z0-9_]``; an op that does not fit is left out and
    the next tried."""
    ops: List[str] = []
    for m in members:
        op = str(m.attrs.get("fn", m.attrs.get("kind", m.opcode))).lower()
        op = re.sub(r"[^a-z0-9_]", "_", op)
        if op not in ops:
            ops.append(op)
    label = ops[0][:LABEL_CHARS] if ops else "fusion"
    for op in ops[1:]:
        if len(label) + 1 + len(op) <= LABEL_CHARS:
            label += "_" + op
    return label


def _name_text(text: str, label: str) -> Tuple[str, str, str]:
    """A kernel's name, ``stitch_`` and the hash of its text (``@K@`` where
    the symbol goes), its ``__global__`` symbol, the name and the fusion's
    label, and its text: the launcher ``<name>_launch`` launches the
    symbol."""
    name = "stitch_" + hashlib.sha256(text.encode()).hexdigest()[:16]
    symbol = _SYMBOLS.setdefault(name, f"{name}_{label}")
    return name, symbol, text.replace("@K@_launch", f"{name}_launch").replace("@K@", symbol)


def _bounds(threads: int, blocks: int) -> str:
    """``__launch_bounds__`` of ``threads`` a block, ``blocks`` an SM."""
    return f"__launch_bounds__({threads}{f', {blocks}' if blocks > 1 else ''})"


def _finish_source(header: str, body: List[str], inputs, roots, grid: int,
                   threads: int, smem: int, static_smem: int,
                   label: str, blocks: int = 1) -> Tuple[str, str, str]:
    """Name a single-phase kernel (``_name_text``) and add its launcher:
    one launch of ``grid`` blocks with ``smem`` bytes of dynamic shared
    memory (where they and the ``static_smem`` bytes pass 48 KB, the
    attribute is set once per device), ``blocks`` an SM
    (``PhaseLaunch.blocks_per_sm``)."""
    if grid > INT_MAX:
        raise NotImplementedError(
            f"a launch of {grid} blocks: gridDim.x is at most 2^31 - 1 ({INT_MAX}) blocks"
        )
    params, lparams, casts = _signature_c(inputs, roots)
    launcher = ['extern "C" int @K@_launch(']
    launcher += [f"    {p}," for p in lparams] + ["    void* stream) {"]
    if smem + static_smem > STATIC_SMEM_LIMIT:
        launcher += [
            f"  static std::atomic<int> ready[{GRID_CACHE_DEVICES}];  // 1: the attribute is set",
            "  int dev = 0;",
            "  cudaError_t e = cudaGetDevice(&dev);",
            "  if (e != cudaSuccess) return static_cast<int>(e);",
            f"  if (dev >= {GRID_CACHE_DEVICES} || !ready[dev].load(std::memory_order_relaxed)) {{",
            f"    e = cudaFuncSetAttribute(@K@, cudaFuncAttributeMaxDynamicSharedMemorySize, {smem});",
            "    if (e != cudaSuccess) return static_cast<int>(e);",
            f"    if (dev < {GRID_CACHE_DEVICES}) ready[dev].store(1, std::memory_order_relaxed);",
            "  }",
        ]
    launcher += [f"  @K@<<<{grid}, {threads}, {smem}, static_cast<cudaStream_t>(stream)>>>("]
    launcher += [f"      {c}," for c in casts[:-1]] + [f"      {casts[-1]});"]
    launcher += ["  return static_cast<int>(cudaGetLastError());", "}", ""]
    text = "\n".join(
        [header, f"__global__ void {_bounds(threads, blocks)} @K@("]
        + [f"    {p}," for p in params[:-1]] + [f"    {params[-1]}) {{"]
        + body + ["}", ""] + launcher
    )
    return _name_text(text, label)


def _wide(fusion: FusedComputation, phases: Sequence["_Phase"], grid: int) -> bool:
    """Whether a kernel must index in 64 bits: a tensor it addresses passes
    ``INT_MAX`` elements, or a loop variable of one of its phases would.  A
    grid-stride loop's variable reaches its count plus the grid's stride
    less one, and the grid is at most ``grid`` blocks (its launch's)."""
    elems = max((_prod(i.shape) for i in list(fusion.inputs) + list(fusion.members)), default=0)
    reach = [ph.extent for ph in phases]
    reach += [n + grid * step - 1 for ph in phases for n, step in ph.strided]
    return max([elems] + reach) > INT_MAX


def _count_map_loops(phases: Sequence["_Phase"]) -> None:
    """Count a kernel's pure-map element loops on the tracer, those that
    walk their output in its own order (``_Phase._ordered_head``), its
    running sums and its staged dots on the tensor cores."""
    tracing.count("codegen.map_loops", sum(ph.map_loops for ph in phases))
    tracing.count("codegen.map_loops_reordered", sum(ph.map_loops_reordered for ph in phases))
    tracing.count("codegen.cumsums", sum(ph.cumsums for ph in phases))
    tracing.count("codegen.mma_dots", sum(ph.mma_dots for ph in phases))


def _index_header(phases: Sequence["_Phase"]) -> str:
    return ", 64-bit indices and offsets" if any(ph.wide for ph in phases) else ""


def _dot_header(phases: Sequence["_Phase"]) -> str:
    """Which loop each fused dot of a kernel took (``_Phase.dot_loop``)."""
    loops = [d for ph in phases for d in ph.dot_loops]
    return f"; dots: {'; '.join(loops)}" if loops else ""


def _cuda_fusion(fusion: FusedComputation, solution: ScheduleSolution, plan: MemoryPlan,
                 launch: PhaseLaunch):
    """The text of ``emit_fusion``'s kernel over ``plan``, launched as
    ``launch`` (``geometry.fusion_launch``) says."""
    inputs, roots = fusion.inputs, fusion.roots
    in_name = {i.id: f"in{k}" for k, i in enumerate(inputs)}
    label = {**in_name, **{m.id: f"m{k}" for k, m in enumerate(fusion.members)}}
    out_of = {r.id: (f"out{k}", tuple(r.shape)) for k, r in enumerate(roots)}
    grid, threads, size = launch.grid, launch.threads, launch.slot_bytes

    def emit(wide: bool):
        ph = _Phase(0, PhaseSolution(fusion.members, roots, solution), plan, launch,
                    in_name, {}, out_of, label, wide=wide)
        return ph, ph.emit()

    ph, phase = emit(False)
    if _wide(fusion, [ph], grid):
        ph, phase = emit(True)
    _count_map_loops([ph])
    smem = max(size if launch.slots_in == SHARED else 0,
               launch.dot_offset + ph.dot_bytes if ph.dot_bytes else 0)
    body = []
    if smem:
        body.append("  extern __shared__ __align__(16) unsigned char sx_smem[];")
    if launch.slots_in == WORKSPACE:
        body.append(f"  unsigned char* const pr0 = ws + static_cast<size_t>(blockIdx.x) * {size};")
    if ph.part_bytes:
        body.append(f"  __shared__ __align__(16) unsigned char sx_part[{ph.part_bytes}];")
    body += phase
    ws = size * grid if launch.slots_in == WORKSPACE else 0
    ws += _stage_region(body, ws, ph.stage_bytes, grid)
    header = (
        f"// emit_fusion: {len(fusion.members)} members, {solution.blocks} plan blocks, "
        f"one launch of {grid} blocks of {threads} threads, {smem} bytes of shared memory "
        f"a block, {ws} workspace bytes"
        + (f", {len(launch.held)} of the plan's slot members held in registers"
           if launch.held else "")
        + _index_header([ph]) + _dot_header([ph])
    )
    name, symbol, text = _finish_source(header, body, inputs, roots, grid, threads, smem,
                                        ph.part_bytes, fusion_label(fusion.members),
                                        launch.blocks_per_sm)
    return name, symbol, text, ws, smem + ph.part_bytes


def _vec_load(addr: str, n: int, name: str, ind: str) -> List[str]:
    """``name``0 .. ``name``{n-1}: ``n`` neighbouring f32 values of shared
    memory at ``addr``, in 16-byte loads (one 8-byte load for 2, one word
    for 1)."""
    if n == 1:
        return [f"{ind}  const float {name}0 = *({addr});"]
    width = min(n, 4)
    out = []
    for q in range(n // width):
        at = f"{addr} + {q * width}" if q else addr
        out += [f"{ind}  const float{width} {name}v{q} = "
                f"*reinterpret_cast<const float{width}*>({at});",
                f"{ind}  const float " + ", ".join(
                    f"{name}{q * width + k} = {name}v{q}.{f}" for k, f in enumerate("xyzw"[:width]))
                + ";"]
    return out


def _lin(idx, shape) -> str:
    """The linear index, in a dense row-major tile of ``shape``, of ``idx``."""
    acc = 0
    for j, st in zip(idx, _dense_strides(shape), strict=True):
        acc = _cadd(acc, _cmul(j, st))
    return str(acc)


def _indices(text: str, ptr: str) -> List[str]:
    """The index expression of every ``ptr[...]`` in ``text``."""
    out, start = [], 0
    key = f"{ptr}["
    while True:
        k = text.find(key, start)
        if k < 0:
            return out
        if k and (text[k - 1].isalnum() or text[k - 1] == "_"):
            start = k + 1
            continue
        depth, j = 1, k + len(key)
        while depth:
            depth += {"[": 1, "]": -1}.get(text[j], 0)
            j += 1
        out.append(text[k + len(key): j - 1])
        start = j


def _counted_loop(var: str, first: str, step: int, n: int, ind: str,
                  itype: str = "int") -> List[str]:
    """The head of a loop of ``var`` over ``first, first + step, ...`` below
    ``n`` as a loop of a fixed count, unrolled, so a thread issues all its
    iterations' loads before it waits for the first; its integers are of C
    type ``itype``."""
    count = -(-n // step)
    lines = [f"{ind}#pragma unroll" + ("" if count <= 32 else " 8"),
             f"{ind}for ({itype} {var}k = 0; {var}k < {count}; ++{var}k) {{",
             f"{ind}  const {itype} {var} = {first} + {var}k * {step};"]
    if n % step:
        lines.append(f"{ind}  if ({var} >= {n}) break;")
    return lines


#: the ops that move an element of their operand unchanged (``_value``)
_MOVES = frozenset(("reshape", "bitcast", "slice", "transpose", "broadcast"))


class _Stored:
    """A view read in the type its elements are stored in (``stored_at``)."""

    def __init__(self, view):
        self.view, self.shape = view, view.shape

    def at(self, idx) -> str:
        return self.view.stored_at(idx)


class _Lazy:
    """An INLINE member read where its consumer needs it: ``at(idx)``
    composes the member's value at ``idx`` into the consumer's expression,
    so no tile is written for it.  Reduces and dots are never INLINE where
    they have a user (the memory plan requires their buffers)."""

    def __init__(self, phase: "_Phase", m: Instruction, stored: Sched, needed: Sched, b):
        self.phase, self.m, self.stored, self.needed, self.b = phase, m, stored, needed, b
        self.shape = chunk_shape(m.shape, needed)

    def at(self, idx) -> str:
        return self._element(idx, False)

    def stored_at(self, idx) -> str:
        """The value in the type it is stored in, rounded once."""
        return self._element(idx, True)

    def _element(self, idx, stored: bool) -> str:
        m, b = self.m, self.b
        if self.stored == self.needed:
            sched, j = self.stored, list(idx)
        elif self.stored.kind == "replicated" and self.needed.kind == "chunked":
            sched = REPLICATED
            j = [_cadd(s, i) for s, i in zip(_c_starts(m.shape, self.needed, b), idx, strict=True)]
        else:
            raise ValueError(f"cannot adapt {m.name}: stored {self.stored}, needed {self.needed}")
        if m.opcode in ("reduce", "dot", "cumsum"):
            raise ValueError(f"{m.name}: an INLINE {m.opcode} with a user has no buffer to read")
        return self.phase.value(m, sched, j, _lin(j, chunk_shape(m.shape, sched)), self.phase.fresh(),
                                stored)


class _Held(_Lazy):
    """A member held in a register (``held_in_registers``): the loop that
    reads it computes it at its element once, into a ``const`` of the type
    it computes in, and reads that at every use."""

    def at(self, idx) -> str:
        ph = self.phase
        key = (self.m.id, tuple(str(i) for i in idx))
        if key not in ph.regs:
            expr = super().at(idx)
            var = f"r{ph.label[self.m.id]}" + (f"_{len(ph.regs)}" if ph.regs else "")
            ph.lines.append(f"{ph.ind}const {_c_compute(self.m.dtype)} {var} = {expr};")
            ph.regs[key] = var
        return ph.regs[key]

    def stored_at(self, idx) -> str:
        return _c_store(self.m.dtype, self.at(idx))


#: a 16-bit dot's output type taken two neighbouring columns at a time, and
#: the intrinsic that rounds two f32 sums into it (``_Phase.mma_dot_loop``)
_PAIRS = {BFLOAT16: ("__nv_bfloat162", "__floats2bfloat162_rn"),
          np.dtype(np.float16): ("__half2", "__floats2half2_rn")}


class _DotStaging:
    """What a staged dot's two loops share (``_Phase.staged_dot_loop``,
    ``_Phase.mma_dot_loop``): the block's walk over its output tiles, BG
    batch elements of BM x BN outputs of its chunk at a time, and over k in
    steps of BK, its threads staging ``lhs[BG x BM x BK]`` and
    ``rhs[BG x BK x BN]`` in shared memory at each step, each value read (a
    composed operand computed) once, along the dimension its source is
    contiguous in, and written transposed where needed into padded rows;
    the next step's values held in registers meanwhile where they are few
    (``geometry.dot_prefetch``).  In a phase with slots the block walks its
    plan block's tiles; in a pure map the blocks of the grid share every
    plan block's tiles.  The loop that computes each step's products and
    writes the outputs is the caller's."""

    def __init__(self, ph: "_Phase", m: Instruction, t: DotTiling, ind: str):
        self.ph, self.m, self.t, self.ind = ph, m, t, ind
        self.sched = ph.sched(m)
        self.out_chunk = chunk_shape(m.shape, self.sched)
        self.bshape = tuple(self.out_chunk[:-2])
        self.T = _c_compute(m.dtype)
        # the staged type: on the tensor cores the operands' own 2-byte type
        self.S = _c_type(m.operands[0].dtype) if t.warps else self.T
        self.itemsize = staged_itemsize(m, t)
        self.pitch = (t.pitch(0), t.pitch(1))
        self.km = t.kmajor or (False, False)          # operands staged [rows][BK + pad]
        self.body, self.inner = ind + "  ", ind + "    "
        self.stage = self.inner + "  "
        self.text: List[str] = []       # what the staging reads, for ``check_slots``
        ph.dot_bytes = max(ph.dot_bytes, t.stage_bytes(self.itemsize))

    def head(self, cores: str, each: str) -> List[str]:
        """The header's line for the dot (``cores``: how the tensor cores
        take it, or nothing), and the loop over the block's output tiles,
        each thread's share of a tile as ``each`` says."""
        ph, m, t, it = self.ph, self.m, self.t, self.ph.itype
        rows, cols = self.out_chunk[-2], self.out_chunk[-1]
        lbl = ph.label[m.id]
        batched = f"{t.bg} x " if t.bg > 1 else ""
        ph.dot_loops.append(f"{lbl} staged in {batched}{t.bm} x {t.bn} tiles{cores}, "
                            f"k steps of {t.bk}")
        tshape = (_prod(self.bshape) // t.bg, rows // t.bm, cols // t.bn)
        per_chunk = _prod(tshape)
        body, inner, S = self.body, self.inner, self.S
        lines = [f"{self.ind}{{  // {lbl}: {batched}{t.bm} x {t.bn} output tiles {each}, "
                 f"k steps of {t.bk} staged in shared memory",
                 f"{body}{S}* const sa = reinterpret_cast<{S}*>(sx_smem + {ph.launch.dot_offset});",
                 f"{body}{S}* const sb = reinterpret_cast<{S}*>(sx_smem + "
                 f"{ph.launch.dot_offset + t.a_bytes(self.itemsize)});"]
        if ph.slot_base is not None:
            ph.extent = max(ph.extent, per_chunk)
            lines.append(f"{body}for ({it} tile = 0; tile < {per_chunk}; ++tile) {{")
        else:
            reps = ph.blocks if self.sched.kind == "chunked" else 1
            total = per_chunk * reps
            ph.extent = max(ph.extent, total)
            ph.strided.append((total, 1))
            lines.append(f"{body}for ({it} u = blockIdx.x; u < {total}; u += gridDim.x) {{")
            if reps > 1:
                lines.append(f"{inner}const {it} b = u / {per_chunk};")
            lines.append(f"{inner}const {it} tile = u % {per_chunk};" if reps > 1
                         else f"{inner}const {it} tile = u;")
        ph.lines, ph.ind = [], inner
        self.tg, tm, tn = _unravel(ph.lines, "tile", tshape, "d", inner, it)
        self.row0, self.col0 = _cmul(tm, t.bm), _cmul(tn, t.bn)
        return lines + ph.lines

    def batch_of(self, gexpr, prefix) -> List:
        """The chunk's batch indices of tile batch element ``gexpr``."""
        t, ph = self.t, self.ph
        first = _cmul(self.tg, t.bg)
        return _unravel(ph.lines, _cadd(first, gexpr) if t.bg > 1 else str(first),
                        self.bshape, prefix, ph.ind, ph.itype) if self.bshape else []

    def compute_ind(self, busy: int) -> str:
        """The indentation of the products: inside ``if (threadIdx.x <
        busy)`` where fewer than the block's threads compute."""
        return self.stage + ("  " if busy < self.ph.threads else "")

    def k_loop(self, busy: int, compute: List[str]) -> List[str]:
        """The walk over k: each step's operand tiles staged (the next
        step's prefetched into registers where they are few), a barrier,
        ``compute`` (the products of one step, at ``compute_ind``) on the
        first ``busy`` threads, a barrier."""
        ph, m, t, sched, th = self.ph, self.m, self.t, self.sched, self.ph.threads
        km, (la, lb_), S, inner, stage = self.km, self.pitch, self.S, self.inner, self.stage
        depth = m.operands[0].shape[-1]
        lhs, rhs = [ph.view(o, ns) for o, ns in zip(m.operands, propagate(m, sched, True), strict=False)]
        row0, col0 = self.row0, self.col0
        operands = [
            ("sa", "pa", lhs, t.bm, la, t.bk * la, not minor_moved(m.operands[0], ph.composed), 0,
             lambda w, kk, kb: [_cadd(row0, w), f"({kb} + {kk})"]),
            ("sb", "pb", rhs, t.bn, lb_, t.bk * lb_, minor_moved(m.operands[1], ph.composed), 1,
             lambda w, kk, kb: [f"({kb} + {kk})", _cadd(col0, w)])]
        # a k-major operand read plainly from a 16-byte aligned region (a
        # staged interface or a slot) is staged 8 neighbouring k at a time
        words = [8 if km[o[7]] and ph._eight_k(o[2], m.operands[o[7]]) else 1 for o in operands]
        counts = [-(-n_w * t.bk * t.bg // wd // th)
                  for (_, _, _, n_w, *_), wd in zip(operands, words, strict=True)]
        # each thread holds the next k step's values in registers while it
        # accumulates the current one, where they are few
        regs = sum(c * (4 if wd == 8 else 1) for c, wd in zip(counts, words, strict=True))
        prefetch = depth > t.bk and regs <= dot_prefetch(t, th)

        def element(n_w, along_k, kmajor, ind, wd=1):
            """A staged element ``e``'s coordinates: ``w`` (row or column),
            ``kk`` and, for a batched tile, ``ge``; where the thread stages
            ``wd`` = 8 neighbouring k at once, those of its 16 bytes ``e``."""
            if wd == 8:
                out = [f"{ind}const int kk = e % {t.bk // 8} * 8;",
                       f"{ind}const int w = e / {t.bk // 8} % {n_w};"]
            elif kmajor:
                # staged k-major (``DotTiling.kmajor``): a warp takes 16 k by
                # 2 rows, a whole sector of each row, and its 32 stores fall
                # in distinct banks (a row's pitch is an odd count of 16 bytes)
                out = [f"{ind}const int kk = e % 16 + e / 32 % {t.bk // 16} * 16;",
                       f"{ind}const int w = e / 16 % 2 + e / {2 * t.bk} % {n_w // 2} * 2;"]
            elif along_k and t.vec and t.bk % 8 == 0 and n_w % 4 == 0:
                # the source is contiguous along k and the padded rows are
                # 16-byte words: a warp takes 8 k by 4 rows, one sector of
                # each row, and its 32 stores fall in 32 banks
                out = [f"{ind}const int kk = e % 8 + e / 32 % {t.bk // 8} * 8;",
                       f"{ind}const int w = e / 8 % 4 + e / {4 * t.bk} % {n_w // 4} * 4;"]
            elif along_k:   # the source is contiguous along k
                out = [f"{ind}const int kk = e % {t.bk};", f"{ind}const int w = e / {t.bk} % {n_w};"]
            else:
                out = [f"{ind}const int w = e % {n_w};", f"{ind}const int kk = e / {n_w} % {t.bk};"]
            return out + ([f"{ind}const int ge = e / {n_w * t.bk};"] if t.bg > 1 else [])

        def staged_at(name, width, per_g, which, wd=1):
            """Element (w, kk) of an operand's staging, or its 16 bytes from
            there (``wd`` = 8)."""
            at = f"ge * {per_g} + " if t.bg > 1 else ""
            if wd == 8:
                return f"*reinterpret_cast<uint4*>(&{name}[w * {width} + kk])"
            return f"{name}[{at}w * {width} + kk]" if km[which] else f"{name}[{at}kk * {width} + w]"

        def walk(count, n, ind):
            """A thread's elements of a staging of ``n`` elements, unrolled."""
            head = [f"{ind}#pragma unroll", f"{ind}for (int ek = 0; ek < {count}; ++ek) {{",
                    f"{ind}  const int e = threadIdx.x + ek * {th};"]
            if n % th:
                head += [f"{ind}  if (e < {n}) {{"]
            return head, ind + ("    " if n % th else "  "), ([f"{ind}  }}"] if n % th else []) + [f"{ind}}}"]

        def stage_values(kb, ind, into_regs):
            """Each thread's staged values at k step ``kb``: into its
            prefetch registers, or straight into shared memory; in the
            staged type (on the tensor cores, as stored: not widened)."""
            out = []
            for (name, reg, view, n_w, width, per_g, along_k, which, where), count, wd in zip(
                    operands, counts, words, strict=True):
                n = n_w * t.bk * t.bg // wd
                head, body_ind, tail = walk(count, n, ind)
                out += head + element(n_w, along_k, km[which], body_ind, wd)
                ph.lines, ph.ind, ph.regs = [], body_ind, {}
                batch = list(ph._dot_batch(m, sched, self.batch_of("ge", f"g{name}"))[which])
                if wd == 8:
                    expr = view.ref(batch + where("w", "kk", kb))
                    self.text.append(expr)
                    expr = f"*reinterpret_cast<const uint4*>(&{expr})"
                else:
                    ph.exact_moves = bool(t.warps)
                    read = view.stored_at if t.warps else view.at
                    expr = read(batch + where("w", "kk", kb))
                    ph.exact_moves = False
                    self.text.extend(ph.lines + [expr])
                out += ph.lines
                dest = f"{reg}[ek]" if into_regs else staged_at(name, width, per_g, which, wd)
                out.append(f"{body_ind}{dest} = {expr};")
                out += tail
            return out

        def store_regs(ind):
            out = []
            for (name, reg, view, n_w, width, per_g, along_k, which, where), count, wd in zip(
                    operands, counts, words, strict=True):
                n = n_w * t.bk * t.bg // wd
                head, body_ind, tail = walk(count, n, ind)
                out += head + element(n_w, along_k, km[which], body_ind, wd)
                out.append(f"{body_ind}{staged_at(name, width, per_g, which, wd)} = {reg}[ek];")
                out += tail
            return out

        lines = []
        if prefetch and words[0] == words[1]:
            kind = "uint4" if words[0] == 8 else S
            lines += [f"{inner}{kind} pa[{counts[0]}], pb[{counts[1]}];  // the next k step's values"]
        elif prefetch:
            lines += [f"{inner}{'uint4' if wd == 8 else S} {reg}[{c}];"
                      + ("  // the next k step's values" if reg == "pa" else "")
                      for (_, reg, *_), c, wd in zip(operands, counts, words, strict=True)]
        if prefetch:
            lines += stage_values("0", inner, True)
        ph.extent = max(ph.extent, depth + t.bk - 1)
        lines.append(f"{inner}for ({ph.itype} k0 = 0; k0 < {depth}; k0 += {t.bk}) {{")
        if prefetch:
            lines += store_regs(stage)
            lines.append(f"{stage}__syncthreads();")
            lines.append(f"{stage}if (k0 + {t.bk} < {depth}) {{")
            lines += stage_values(f"k0 + {t.bk}", stage + "  ", True)
            lines.append(f"{stage}}}")
        else:
            lines += stage_values("k0", stage, False)
            lines.append(f"{stage}__syncthreads();")
        if busy < th:
            lines.append(f"{stage}if (threadIdx.x < {busy}) {{")
        lines += compute
        if busy < th:
            lines.append(f"{stage}}}")
        return lines + [f"{stage}__syncthreads();", f"{inner}}}"]

    def outputs(self, busy: int) -> Tuple[List[str], List, str]:
        """The head of the writes of a tile's outputs: its lines, the
        chunk's batch indices of the thread's outputs, and the writes'
        indentation."""
        ph, inner = self.ph, self.inner
        out = inner + ("  " if busy < ph.threads else "")
        lines = [f"{inner}if (threadIdx.x < {busy}) {{"] if busy < ph.threads else []
        ph.lines, ph.ind = [], out
        obatch = self.batch_of("gi", "go")
        return lines + ph.lines, list(obatch), out

    def check_slots(self, outs) -> None:
        """``_Phase._check_own_slot`` of each output ``outs`` names against
        what the staging read."""
        for _, j in outs:
            self.ph._check_own_slot(self.m, self.ph._tile_write(self.m, self.out_chunk, j),
                                    "\n".join(self.text))

    def close(self, busy: int) -> List[str]:
        """The ends of the writes' guard, the tile loop and the dot's block."""
        return ([f"{self.inner}}}"] if busy < self.ph.threads else []) + [f"{self.body}}}", f"{self.ind}}}"]


class _Phase:
    """The CUDA text of one phase: a phase of a stitched kernel, or the
    single phase of an ``emit_fusion`` kernel, as ``launch`` (its
    ``geometry.PhaseLaunch``) lays it out: its threads, the members that
    write a slot and the slots' offsets, where the slots live
    (``slot_base`` names them: ``sx_smem``, or ``pr<k>`` for a per-block
    workspace region; None: no member writes one, and the phase is a pure
    map over the grid), the members held in a register in place of their
    slot, a single-phase kernel's independent member groups, each run by a
    CUDA block of its own for each plan block, and the loop each dot
    takes.  ``wide``: every index in 64 bits (``_wide``)."""

    def __init__(self, pk: int, phase, pplan: MemoryPlan, launch: PhaseLaunch, in_name, staged,
                 out_of, label, wide: bool):
        self.pk, self.phase, self.pplan, self.launch = pk, phase, pplan, launch
        self.threads = launch.threads
        # indices, offsets and loop variables in 64 bits where a loop or a
        # tensor passes INT_MAX (``_index_type``), else in ``int``
        self.wide = wide
        self.itype = "long long" if wide else "int"
        self.extent = 0         # the largest value a loop variable or index reaches
        self.strided: List[Tuple[int, int]] = []  # grid-stride loops: (count, step a grid block)
        self.assign = phase.solution.assignment
        self.blocks = phase.solution.blocks
        self.b = _Sym("b") if self.blocks > 1 else 0
        self.in_name, self.staged, self.out_of, self.label = in_name, staged, out_of, label
        self.ids = {m.id for m in phase.members}
        self.const_ids = {m.id for m in phase.members if m.opcode == "constant"}
        self.slot_base = {SHARED: "sx_smem", WORKSPACE: f"pr{pk}"}.get(launch.slots_in)
        self.held = launch.held               # members held in a register
        self.slot_ptr: Dict[int, str] = {}    # slot index -> pointer name
        self.tiles: Dict[int, str] = {}       # ALLOC/SHARE member -> its slot
        for mid, slot in launch.tiles.items():
            self.slot_ptr.setdefault(slot, f"p{pk}s{slot}")
            self.tiles[mid] = self.slot_ptr[slot]
        self.regs: Dict[Tuple[int, Tuple[str, ...]], str] = {}  # this loop's held values
        self.lines: List[str] = []
        self.ind = ""
        self.n = 0
        self.part_bytes = 0     # static shared memory of the block-wide reduces
        self.restaged: set = set()   # SHARE members that write through sx_stage
        self.stage_bytes = 0    # the largest tile written through sx_stage
        self.dot_bytes = 0      # the largest staging of a dot's operand tiles
        self.dot_loops: List[str] = []   # which loop each dot took, for the header
        self.map_loops = 0      # element loops of a pure map (``element_loop``)
        self.map_loops_reordered = 0   # those that walk their output in its order
        self.cumsums = 0        # running sums (``cumsum_loop``)
        self.mma_dots = 0       # staged dots on the tensor cores (``mma_dot_loop``)
        self.exact_moves = False   # moved elements not rounded again (``value``)
        self.composed = {m.id for m in phase.members} - set(self.tiles)

    def fresh(self) -> str:
        self.n += 1
        return f"{self.n}c"

    def sched(self, m: Instruction) -> Sched:
        return REPLICATED if m.id in self.const_ids else self.assign[m.id]

    def view(self, o: Instruction, ns: Sched):
        if o.id in self.const_ids:
            return _literal_view(o, ns)
        if o.id in self.tiles:
            st = self.assign[o.id]
            return _tile_view(self.tiles[o.id], chunk_shape(o.shape, st), st, ns, o, self.b, full=False,
                              wide=self.wide)
        if o.id in self.held:
            return _Held(self, o, self.assign[o.id], ns, self.b)
        if o.id in self.ids:
            return _Lazy(self, o, self.assign[o.id], ns, self.b)
        # kernel input or staged interface: stored whole
        src = self.in_name[o.id] if o.id in self.in_name else self.staged[o.id]
        return _tile_view(src, o.shape, REPLICATED, ns, o, self.b, full=True, wide=self.wide)

    def value(self, m: Instruction, sched: Sched, idx, lin: str, sfx: str,
              stored: bool = False) -> str:
        """Element ``idx`` of ``m``, rounded to its dtype where it ends: in
        the type it is computed in, or (``stored``) in the type it is
        stored in.  While a dot on the tensor cores stages its operands
        (``exact_moves``), a member that moves its operand's element
        unchanged (``_MOVES``) is not rounded again: the element is of its
        dtype already, read as it is stored or widened once."""
        ovs = [self.view(o, ns) for o, ns in zip(m.operands, propagate(m, sched, True), strict=False)]
        moved = self.exact_moves and m.opcode in _MOVES
        if moved and stored:
            ovs = [_Stored(v) for v in ovs]
        expr = _value(m, sched, ovs, idx, self.b, self.lines, self.ind, self.itype, lin=lin,
                      sfx=sfx)
        if moved:
            return expr
        return _c_store(m.dtype, expr) if stored else _c_round(m.dtype, expr)

    # ---- the loops ---------------------------------------------------------
    def _stores(self, m: Instruction, sched: Sched, idx, v: str) -> List[str]:
        """The fusion outputs and staged interfaces ``m`` writes."""
        dests = [self.out_of[m.id]] if m.id in self.out_of else []
        if m.id in self.staged:
            dests.append((self.staged[m.id], tuple(m.shape)))
        offs = _c_starts(m.shape, sched, self.b)
        out_chunk = chunk_shape(m.shape, sched)
        return [f"{_View(out_chunk, p, _dense_strides(full), offs, wide=self.wide).ref(idx)} = "
                f"{_c_store(m.dtype, v)};" for p, full in dests]

    def _tile_write(self, m: Instruction, out_chunk, idx) -> Optional[str]:
        if m.id not in self.tiles:
            return None
        ptr = self.tiles[m.id]
        if m.id in self.restaged:
            ptr = f"reinterpret_cast<{_c_type(m.dtype)}*>(sx_stage)"
        return _View(out_chunk, ptr, _dense_strides(out_chunk), (0,) * len(out_chunk),
                     wide=self.wide).ref(idx)

    def _check_own_slot(self, m: Instruction, write: Optional[str], text: str) -> None:
        """A SHARE member may write its slot in place only where it reads
        its slot's previous owner (through the values composed into it) at
        no other element than the one the same thread then writes.  Where
        it reads another element (a transposed or reversed read), another
        thread could already have overwritten that one, so the member writes
        its tile to a staging region of the workspace instead (``sx_stage``),
        and after a block barrier the tile is copied into the slot
        (``member_loop``).  A member already restaged stays so."""
        if write is None or m.id in self.restaged:
            return
        ptr = self.tiles[m.id]
        mine = _indices(write, ptr)
        if any(i != mine[0] for i in _indices(text, ptr)):
            self.restaged.add(m.id)

    def _refs(self, m: Instruction, sched: Sched, out_chunk, idx) -> List[str]:
        """Every element ``idx`` of ``m`` is written to: its slot tile, its
        outputs and its staged interface."""
        write = self._tile_write(m, out_chunk, idx)
        return ([] if write is None else [write]) + [
            s.split(" = ")[0] for s in self._stores(m, sched, idx, "v")]

    def _writes(self, m: Instruction, sched: Sched, out_chunk, idx, v: str, ind: str) -> List[str]:
        """The slot tile and the outputs that computed value ``v`` of
        element ``idx`` goes to."""
        write = self._tile_write(m, out_chunk, idx)
        lines = [] if write is None else [f"{ind}{write} = {_c_store(m.dtype, v)};"]
        return lines + [ind + s for s in self._stores(m, sched, idx, v)]

    def _loop_head(self, var: str, n: int, sched: Sched, ind: str) -> List[str]:
        """The head of the loop over ``n`` elements of a member's tile: in
        a phase with slots, the block's threads over one plan block's tile;
        in a pure map, every plan block's elements over the whole grid."""
        th, it = self.threads, self.itype
        if self.slot_base is not None:
            self.extent = max(self.extent, n)
            return self._counted(var, "threadIdx.x", th, n, ind)
        reps = self.blocks if sched.kind == "chunked" else 1
        body = ind + "  "
        lines = [self._grid_loop(n * reps, ind)]
        if reps > 1:
            lines.append(f"{body}const {it} b = t / {n};")
            lines.append(f"{body}const {it} {var} = t % {n};")
        else:
            lines.append(f"{body}const {it} {var} = t;")
        return lines

    def _grid_loop(self, total: int, ind: str) -> str:
        """The head of a loop of ``t`` over ``total`` elements strided over
        the whole grid, its reach recorded."""
        self.extent = max(self.extent, total)
        self.strided.append((total, self.threads))
        return f"{ind}for ({self.itype} t = {self._thread()}; t < {total}; t += {self._stride()}) {{"

    def _counted(self, var: str, first: str, step: int, n: int, ind: str) -> List[str]:
        """``_counted_loop`` in ``itype``: its variable reaches the last
        multiple of ``step`` at or past ``n``, less one."""
        self.extent = max(self.extent, -(-n // step) * step - 1)
        return _counted_loop(var, first, step, n, ind, self.itype)

    def _thread(self) -> str:
        """The thread's index in the grid, formed in ``itype``."""
        first = "static_cast<long long>(blockIdx.x)" if self.wide else "blockIdx.x"
        return f"{first} * {self.threads} + threadIdx.x"

    def _stride(self) -> str:
        """The grid's threads, formed in ``itype``."""
        first = "static_cast<long long>(gridDim.x)" if self.wide else "gridDim.x"
        return f"{first} * {self.threads}"

    def _ordered_head(self, m: Instruction, sched: Sched, ind: str) -> Tuple[List[str], List]:
        """The head of a pure map's loop over ``m`` whose chunk is not one
        contiguous span of it: ``t`` is the element's row-major position in
        ``m``, so a warp's threads write neighbouring elements, and each
        recovers its plan block ``b`` and its index in the chunk (returned)
        from it.  Its count and stride are ``_loop_head``'s (``_grid_loop``)."""
        it = self.itype
        shape = tuple(m.shape)
        chunk = chunk_shape(shape, sched)
        body = ind + "  "
        lines = [self._grid_loop(_prod(shape), ind)]
        g = _unravel(lines, "t", shape, "g", body, it)
        q: List = [0] * len(shape)
        idx: List = [0] * len(shape)
        for d, (n, c) in enumerate(zip(shape, chunk, strict=True)):
            if c == n:
                idx[d] = g[d]
            elif c == 1:
                q[d] = g[d]
            else:
                q[d], idx[d] = f"q{d}", f"o{d}"
                lines.append(f"{body}const {it} q{d} = {g[d]} / {c}; const {it} o{d} = {g[d]} % {c};")
        lines.append(f"{body}const {it} b = {_block_of(shape, sched, q)};")
        return lines, idx

    def element_loop(self, m: Instruction, ind: str) -> List[str]:
        sched = self.sched(m)
        out_chunk = chunk_shape(m.shape, sched)
        body = ind + "  "
        self.lines, self.ind, self.regs = [], body, {}
        ordered = self.slot_base is None and not _contiguous(m.shape, out_chunk)
        if self.slot_base is None:
            self.map_loops += 1
            self.map_loops_reordered += ordered
        if ordered:
            lines, idx = self._ordered_head(m, sched, ind)
            lin = _lin(idx, out_chunk)
        else:
            lines = self._loop_head("i", _prod(out_chunk), sched, ind)
            idx, lin = _unravel(self.lines, "i", out_chunk, "o", body, self.itype), "i"
        expr = self.value(m, sched, idx, lin, "")
        stmts = self.lines
        self._check_own_slot(m, self._tile_write(m, out_chunk, idx), "\n".join(stmts) + expr)
        lines += stmts
        lines.append(f"{body}const {_c_compute(m.dtype)} v = {expr};")
        lines += self._writes(m, sched, out_chunk, idx, "v", body)
        lines.append(f"{ind}}}")
        return lines

    def _dot_batch(self, m: Instruction, sched: Sched, g) -> Tuple[List, List]:
        """The batch indices each operand of dot ``m`` is read at, for the
        chunk's batch indices ``g``: the chunk's own, or, for an operand
        read whole under a chunked dot (a row split's rhs), the output's."""
        ns = propagate(m, sched, True)
        ost = _c_starts(m.shape, sched, self.b)
        own = list(g)
        whole = [_cadd(s, i) for s, i in zip(ost, g)]
        return tuple(whole if s.kind == "replicated" and sched.kind == "chunked" else own
                     for s in ns)

    def _eight_k(self, view, o: Instruction) -> bool:
        """Whether a staged read ``view`` of dot operand ``o`` may load 8
        neighbouring k, 16 bytes, at once: ``o`` itself, 2 bytes an element,
        in a staged interface or a slot (16-byte aligned regions, where a
        kernel input need not be), contiguous along k, every other stride
        and the offset along k a multiple of 8 elements."""
        return (isinstance(view, _View) and not view.literal and np.dtype(o.dtype).itemsize == 2
                and np.dtype(view.dtype) == np.dtype(o.dtype)
                and (view.ptr in self.staged.values() or view.ptr in self.tiles.values())
                and view.strides[-1] == 1 and all(st % 8 == 0 for st in view.strides[:-1])
                and isinstance(view.offs[-1], int) and view.offs[-1] % 8 == 0)

    def dot_loop(self, m: Instruction, ind: str) -> List[str]:
        """A fused dot, staged (``staged_dot_loop``, ``mma_dot_loop``) where
        the launch gives it a tiling (its operand tiles fit in the shared
        memory its slots leave), else each thread a register tile of up to 4 x 4 outputs
        (rows and columns strided by the tile's count of them, so the lanes
        of a warp read neighbouring columns and rows) reading its operands
        where they are, so each k loads 4 + 4 operands for 16 FMAs.  f32
        FMAs in the reference's order of k (the 2e-5 tolerance forbids
        TF32); only a staged dot of 16-bit operands takes the tensor
        cores."""
        sched = self.sched(m)
        tiling = self.launch.tilings[m.id]
        if tiling is not None:
            loop = self.mma_dot_loop if tiling.warps else self.staged_dot_loop
            return loop(m, ind, tiling)
        self.dot_loops.append(f"{self.label[m.id]} the register-tile loop")
        out_chunk = chunk_shape(m.shape, sched)
        rows, cols = out_chunk[-2], out_chunk[-1]
        rm, rn = _reg_tile(rows, cols)
        gshape = tuple(out_chunk[:-2]) + (rows // rm, cols // rn)
        T = _c_compute(m.dtype)
        body = ind + "  "
        lines = self._loop_head("i", _prod(gshape), sched, ind)
        self.lines, self.ind = [], body
        g = _unravel(self.lines, "i", gshape, "o", body, self.itype)
        ms = [_cadd(g[-2], r * (rows // rm)) for r in range(rm)]
        ns = [_cadd(g[-1], c * (cols // rn)) for c in range(rn)]
        lhs, rhs = [self.view(o, ns_) for o, ns_ in zip(m.operands, propagate(m, sched, True), strict=False)]
        lb, rb = self._dot_batch(m, sched, g[:-2])
        depth = lhs.shape[-1]
        self.lines.append(f"{body}{T} acc[{rm * rn}] = {{}};")
        self.lines.append(f"{body}#pragma unroll" + ("" if depth <= 32 else " 8"))
        self.extent = max(self.extent, depth)
        self.lines.append(f"{body}for ({self.itype} k = 0; k < {depth}; ++k) {{")
        self.ind = body + "  "
        for r, row in enumerate(ms):
            self.lines.append(f"{body}  const {T} a{r} = {lhs.at(lb + [row, 'k'])};")
        for c, col in enumerate(ns):
            self.lines.append(f"{body}  const {T} c{c} = {rhs.at(rb + ['k', col])};")
        for r in range(rm):
            for c in range(rn):
                self.lines.append(f"{body}  acc[{r * rn + c}] = sx_fma(a{r}, c{c}, acc[{r * rn + c}]);")
        self.lines.append(f"{body}}}")
        self.ind = body
        stmts = self.lines
        outs = [(r * rn + c, list(g[:-2]) + [row, col]) for r, row in enumerate(ms) for c, col in enumerate(ns)]
        for _, j in outs:
            self._check_own_slot(m, self._tile_write(m, out_chunk, j), "\n".join(stmts))
        lines += stmts
        for a, j in outs:
            lines.append(f"{body}{{")
            lines.append(f"{body}  const {T} v = {_c_round(m.dtype, f'acc[{a}]')};")
            lines += self._writes(m, sched, out_chunk, j, "v", body + "  ")
            lines.append(f"{body}}}")
        lines.append(f"{ind}}}")
        return lines

    def staged_dot_loop(self, m: Instruction, ind: str, t: DotTiling) -> List[str]:
        """A fused dot whose block computes a tile of BG batch elements of
        BM x BN outputs of its chunk at a time (``_DotStaging``), each
        thread an rm x rn register tile of it, accumulated by f32 FMAs from
        the shared memory each k step's operand tiles are staged in, in
        16-byte words where its rows and columns are neighbours
        (``DotTiling.vec``).  The FMAs run in the reference's order of k,
        so each output is the register-tile loop's to the bit.  A tiling on
        the tensor cores (``DotTiling.warps``) takes ``mma_dot_loop``."""
        st = _DotStaging(self, m, t, ind)
        T, th, inner = st.T, self.threads, st.inner
        tx, ty = t.bn // t.rn, t.bm // t.rm
        busy = t.bg * tx * ty
        lines = st.head("", f"of {t.rm} x {t.rn} a thread")
        if t.bg > 1:
            lines += [f"{inner}const int gi = threadIdx.x / {tx * ty};",
                      f"{inner}const int ty = threadIdx.x / {tx} % {ty};"]
        else:
            lines.append(f"{inner}const int ty = threadIdx.x / {tx};")
        lines += [f"{inner}const int tx = threadIdx.x % {tx};",
                  f"{inner}{T} acc[{t.rm * t.rn}] = {{}};"]
        comp = st.compute_ind(busy)
        la, lb_ = st.pitch
        ga, gb = (f"gi * {t.bk * la} + ", f"gi * {t.bk * lb_} + ") if t.bg > 1 else ("", "")
        compute = [f"{comp}#pragma unroll", f"{comp}for (int kk = 0; kk < {t.bk}; ++kk) {{"]
        if t.vec:
            compute += _vec_load(f"sa + {ga}kk * {la} + ty{f' * {t.rm}' if t.rm > 1 else ''}",
                                 t.rm, "a", comp)
            compute += _vec_load(f"sb + {gb}kk * {lb_} + tx{f' * {t.rn}' if t.rn > 1 else ''}",
                                 t.rn, "c", comp)
        else:
            compute += [f"{comp}  const {T} a{r} = sa[{ga}kk * {la} + ty{f' + {r * ty}' if r else ''}];"
                        for r in range(t.rm)]
            compute += [f"{comp}  const {T} c{c} = sb[{gb}kk * {lb_} + tx{f' + {c * tx}' if c else ''}];"
                        for c in range(t.rn)]
        compute += [f"{comp}  acc[{r * t.rn + c}] = sx_fma(a{r}, c{c}, acc[{r * t.rn + c}]);"
                    for r in range(t.rm) for c in range(t.rn)]
        lines += st.k_loop(busy, compute + [f"{comp}}}"])
        out_lines, obatch, out = st.outputs(busy)
        lines += out_lines

        def at(base, var, k, n, width):
            """Register ``k``'s row (or column) ``var`` holds, past ``base``."""
            if t.vec and width > 1:
                return _cadd(base, f"({var} * {width} + {k})" if k else f"({var} * {width})")
            return _cadd(base, f"({var} + {k * n})" if k else var)

        outs = [(r * t.rn + c, obatch + [at(st.row0, "ty", r, ty, t.rm), at(st.col0, "tx", c, tx, t.rn)])
                for r in range(t.rm) for c in range(t.rn)]
        st.check_slots(outs)
        sched, out_chunk = st.sched, st.out_chunk
        if t.vec and t.rn > 1 and _c_type(m.dtype) == "float" and m.id not in self.restaged:
            # each register row's neighbouring columns in one 16- or 8-byte store
            for r in range(t.rm):
                j = outs[r * t.rn][1]
                vals = ", ".join(f"acc[{r * t.rn + c}]" for c in range(t.rn))
                for ref in self._refs(m, sched, out_chunk, j):
                    lines.append(f"{out}*reinterpret_cast<float{t.rn}*>(&{ref}) = "
                                 f"make_float{t.rn}({vals});")
        else:
            for a, j in outs:
                lines.append(f"{out}{{")
                lines.append(f"{out}  const {T} v = {_c_round(m.dtype, f'acc[{a}]')};")
                lines += self._writes(m, sched, out_chunk, j, "v", out + "  ")
                lines.append(f"{out}}}")
        return lines + st.close(busy)

    def mma_dot_loop(self, m: Instruction, ind: str, t: DotTiling) -> List[str]:
        """A staged dot on the tensor cores (``DotTiling.warps``: both
        operands bf16, or both f16): the block walks its tiles as the FMA
        loop does (``_DotStaging``), its operands staged in their own
        2-byte type, which is exact, since every staged value is already
        rounded to it, in rows padded for ``ldmatrix``: an operand whose
        source is contiguous along k k-major (``[BM][BK + pad]``,
        ``[BN][BK + pad]``; ``DotTiling.kmajor``), read by ``ldmatrix.x4``,
        and 16 bytes at a time where it is read plainly from an aligned
        region (``_eight_k``); the others as ``[BK][BM + pad]`` and
        ``[BK][BN + pad]``, read by ``ldmatrix.x4.trans``.  Each warp
        computes its warp tile by ``mma.sync`` m16n8k16 in f32 sums.  The
        product of two such values is exact in f32, so only the order of
        the sums differs from the FMA loop's.  An output stored whole takes
        each fragment's two neighbouring columns in one 4-byte store; a
        slot tile (or its restaging) element by element."""
        st = _DotStaging(self, m, t, ind)
        (wm, wn), (nwm, nwn) = t.warp_tile, t.warps
        busy, inner, S = nwm * nwn * 32, st.inner, st.S
        self.mma_dots += 1
        cores = f"on the tensor cores, {nwm} x {nwn} warps of {wm} x {wn}"
        lines = st.head(f" {cores}", cores)
        (la, lb_), km = st.pitch, st.km
        # the warp's tile at rows wr, columns wc; ra and rb: the lane's
        # ldmatrix row of the lhs and of the rhs in a k step's staging
        ra = (f"(wr + lane % 8 + lane / 8 % 2 * 8) * {la} + lane / 16 * 8" if km[0]
              else f"(lane / 16 * 8 + lane % 8) * {la} + wr + lane / 8 % 2 * 8")
        rb = (f"(wc + lane % 8 + lane / 16 * 8) * {lb_} + lane / 8 % 2 * 8" if km[1]
              else f"(lane / 8 % 2 * 8 + lane % 8) * {lb_} + wc + lane / 16 * 8")
        lines += [f"{inner}const int lane = threadIdx.x % 32;",
                  f"{inner}const int wr = " + (f"threadIdx.x / {32 * nwn} * {wm};" if nwm > 1 else "0;"),
                  f"{inner}const int wc = " + (f"threadIdx.x / 32 % {nwn} * {wn};" if nwn > 1 else "0;"),
                  f"{inner}const int ra = {ra};", f"{inner}const int rb = {rb};",
                  f"{inner}float acc[{wm // 16 * (wn // 8)}][4] = {{}};"]
        comp = st.compute_ind(busy)
        # each 16 k: the warp tile's lhs fragments (m16 x k16) and rhs
        # fragments (k16 x n8, two to an ldmatrix), then its products
        mi, ni = wm // 16, wn // 8
        compute = [f"{comp}#pragma unroll", f"{comp}for (int kk = 0; kk < {t.bk}; kk += 16) {{",
                   f"{comp}  unsigned fa[{mi}][4], fb[{ni}][2];"]
        # k-major rows by ldmatrix, the others transposed by ldmatrix .trans
        step = [(("", "kk", 16 * la) if km[0] else ("_trans", f"kk * {la}", 16)),
                (("", "kk", 16 * lb_) if km[1] else ("_trans", f"kk * {lb_}", 16))]
        compute += [f"{comp}  sx_ldmatrix_x4{step[0][0]}(fa[{i}], sa + ra + {step[0][1]}"
                    f"{f' + {step[0][2] * i}' if i else ''});" for i in range(mi)]
        compute += [f"{comp}  sx_ldmatrix_x4{step[1][0]}(fb[{2 * j}], fb[{2 * j + 1}], sb + rb + "
                    f"{step[1][1]}{f' + {step[1][2] * j}' if j else ''});" for j in range(ni // 2)]
        compute += [f"{comp}  sx_mma_16816<{S}>(acc[{i * ni + j}], fa[{i}], fb[{j}]);"
                    for i in range(mi) for j in range(ni)]
        lines += st.k_loop(busy, compute + [f"{comp}}}"])
        out_lines, obatch, out = st.outputs(busy)
        lines += out_lines
        # fragment (i, j)'s sums: row lane / 4 (+ 8 for h = 1) of its m16
        # piece, columns lane % 4 * 2 + c of its n8 piece
        outs = [(f"{i * ni + j}][{2 * h + c}", obatch + [
            _cadd(st.row0, f"(wr + lane / 4{f' + {16 * i + 8 * h}' if i or h else ''})"),
            _cadd(st.col0, f"(wc + lane % 4 * 2{f' + {8 * j + c}' if j or c else ''})")])
            for i in range(mi) for j in range(ni) for h in range(2) for c in range(2)]
        st.check_slots(outs)
        pair, make = _PAIRS[np.dtype(m.dtype)]
        for (a, j), (a1, j1) in zip(outs[::2], outs[1::2], strict=True):
            for ak, jk in ((a, j), (a1, j1)):
                write = self._tile_write(m, st.out_chunk, jk)
                if write is not None:
                    lines.append(f"{out}{write} = {_c_store(m.dtype, f'acc[{ak}]')};")
            for ref in self._stores(m, st.sched, j, "v"):
                lines.append(f"{out}*reinterpret_cast<{pair}*>(&{ref.split(' = ')[0]}) = "
                             f"{make}(acc[{a}], acc[{a1}]);")
        return lines + st.close(busy)

    def reduce_loop(self, m: Instruction, ind: str) -> List[str]:
        """A cooperative reduce: a warp per output element, its lanes
        striding over the reduced elements, then a butterfly of shuffles.
        Where a plan block has fewer outputs than its block has warps, the
        warps share them (``_block_reduce``)."""
        sched = self.sched(m)
        out_chunk = chunk_shape(m.shape, sched)
        r_out, T, th = _prod(out_chunk), _c_compute(m.dtype), self.threads
        warps = th // 32
        pure = self.slot_base is None
        if not pure and 2 * r_out <= warps:
            return self._block_reduce(m, ind)
        (src,) = [self.view(o, ns) for o, ns in zip(m.operands, propagate(m, sched, True), strict=False)]
        rdims = tuple(m.attrs["dims"])
        kind = m.attrs["kind"]
        kept = [k for k in range(len(src.shape)) if k not in rdims]
        extent = [src.shape[k] for k in rdims]
        reps = self.blocks if pure and sched.kind == "chunked" else 1
        body = ind + "  "
        lines = []
        it = self.itype
        self.extent = max(self.extent, r_out, _prod(extent))
        if pure:
            total = r_out * reps
            self.extent = max(self.extent, total * 32)
            self.strided.append((total, th))
            lines.append(f"{ind}for ({it} ow = ({self._thread()}) >> 5; ow < {total}; "
                         f"ow += ({self._stride()}) >> 5) {{")
            if reps > 1:
                lines.append(f"{body}const {it} b = ow / {r_out};")
                lines.append(f"{body}const {it} o = ow % {r_out};")
            else:
                lines.append(f"{body}const {it} o = ow;")
        self.lines, self.ind = [], body
        idx = _unravel(self.lines, "o", out_chunk, "o", body, it)
        j: List = [0] * len(src.shape)
        for kk, k in enumerate(kept):
            j[k] = idx[kk]
        self.lines.append(f"{body}{T} acc = {_REDUCE_INIT[kind].format(T=T)};")
        self.lines += self._counted("r", "(threadIdx.x & 31)", 32, _prod(extent), body)
        self.ind = body + "  "
        for k, q in zip(rdims, _unravel(self.lines, "r", extent, "q", body + "  ", it), strict=True):
            j[k] = q
        self.lines.append(f"{body}  {_REDUCE_STEP[kind].format(x=src.at(j))}")
        self.lines.append(f"{body}}}")
        self.lines.append(f"{body}acc = sx_warp_allreduce(acc, {_REDUCE_COMBINE[kind]}());")
        self.ind = body
        v = f"(acc / static_cast<{T}>({_prod(extent)}))" if kind == "mean" else "acc"
        stmts = self.lines
        self._check_own_slot(m, self._tile_write(m, out_chunk, idx), "\n".join(stmts))
        if not pure:
            self.extent = max(self.extent, r_out + warps - 1)
            lines.append(f"{ind}for ({it} o = threadIdx.x >> 5; o < {r_out}; o += {warps}) {{")
        lines += stmts
        lines.append(f"{body}if ((threadIdx.x & 31) == 0) {{")
        lines.append(f"{body}  const {T} v = {_c_round(m.dtype, v)};")
        lines += self._writes(m, sched, out_chunk, idx, "v", body + "  ")
        lines += [f"{body}}}", f"{ind}}}"]
        return lines

    def _block_reduce(self, m: Instruction, ind: str) -> List[str]:
        """A reduce with fewer outputs than warps: the block's warps share
        them, P = warps // outputs to each.  Warp w takes part w / outputs
        of output w % outputs, its lanes striding over the terms by 32 P;
        each warp combines its lanes by shuffles and leaves its partial
        result in shared memory (``sx_part``); after a barrier, thread o
        combines output o's P partials in order.  The barrier also makes it
        safe for a SHARE member to read its slot anywhere: every read comes
        before it, every write after."""
        sched = self.sched(m)
        out_chunk = chunk_shape(m.shape, sched)
        r_out, T, th = _prod(out_chunk), _c_compute(m.dtype), self.threads
        warps = th // 32
        parts = warps // r_out
        (src,) = [self.view(o, ns) for o, ns in zip(m.operands, propagate(m, sched, True), strict=False)]
        rdims = tuple(m.attrs["dims"])
        kind = m.attrs["kind"]
        comb = _REDUCE_COMBINE[kind]
        kept = [k for k in range(len(src.shape)) if k not in rdims]
        extent = [src.shape[k] for k in rdims]
        self.part_bytes = reduce_part_bytes(th)
        body, inner = ind + "  ", ind + "    "
        lines = [f"{ind}{{  // {parts} warps an output, partial results through shared memory",
                 f"{body}{T}* const part = reinterpret_cast<{T}*>(sx_part);",
                 f"{body}const int w = threadIdx.x >> 5;",
                 f"{body}{T} acc = {_REDUCE_INIT[kind].format(T=T)};",
                 f"{body}if (w < {r_out * parts}) {{",
                 f"{inner}const int o = w % {r_out};",
                 f"{inner}const int p = w / {r_out};"]
        it = self.itype
        self.extent = max(self.extent, _prod(extent))
        self.lines, self.ind = [], inner
        idx = _unravel(self.lines, "o", out_chunk, "o", inner, it)
        j: List = [0] * len(src.shape)
        for kk, k in enumerate(kept):
            j[k] = idx[kk]
        self.lines += self._counted("r", "((threadIdx.x & 31) + 32 * p)", 32 * parts, _prod(extent),
                                    inner)
        self.ind = inner + "  "
        for k, q in zip(rdims, _unravel(self.lines, "r", extent, "q", inner + "  ", it), strict=True):
            j[k] = q
        self.lines.append(f"{inner}  {_REDUCE_STEP[kind].format(x=src.at(j))}")
        self.lines.append(f"{inner}}}")
        self.lines.append(f"{inner}acc = sx_warp_allreduce(acc, {comb}());")
        lines += self.lines
        lines += [f"{body}}}",
                  f"{body}if ((threadIdx.x & 31) == 0) part[w] = acc;",
                  f"{body}__syncthreads();",
                  f"{body}if (threadIdx.x < {r_out}) {{",
                  f"{inner}const int o = threadIdx.x;",
                  f"{inner}{T} tot = part[o];",
                  f"{inner}for (int p = 1; p < {parts}; ++p) tot = {comb}()(tot, part[o + p * {r_out}]);"]
        self.ind = inner
        idx = _unravel(lines, "o", out_chunk, "o", inner, it)
        v = f"(tot / static_cast<{T}>({_prod(extent)}))" if kind == "mean" else "tot"
        lines.append(f"{inner}const {T} v = {_c_round(m.dtype, v)};")
        lines += self._writes(m, sched, out_chunk, idx, "v", inner)
        lines += [f"{body}}}", f"{ind}}}"]
        return lines

    def cumsum_loop(self, m: Instruction, ind: str) -> List[str]:
        """A running sum: one thread walks each row of the tile along the
        summed dim, which the tile holds whole (``schedule.propagate``),
        adding each term to its accumulator and writing it, O(n) a row.
        Threads take rows as an element loop takes elements: a block's
        threads over one plan block's rows where the phase has slots, the
        whole grid's over every plan block's rows in a pure map."""
        sched = self.sched(m)
        out_chunk = chunk_shape(m.shape, sched)
        d = m.attrs["dim"]
        rows = tuple(1 if k == d else n for k, n in enumerate(out_chunk))
        T, it = _c_compute(m.dtype), self.itype
        (src,) = [self.view(o, ns) for o, ns in zip(m.operands, propagate(m, sched, True), strict=False)]
        body, inner = ind + "  ", ind + "    "
        self.cumsums += 1
        self.extent = max(self.extent, out_chunk[d])
        lines = self._loop_head("o", _prod(rows), sched, ind)
        self.lines, self.ind, self.regs = [], body, {}
        idx = _unravel(self.lines, "o", rows, "o", body, it)
        idx[d] = "r"
        lines += self.lines
        lines.append(f"{body}{T} acc = static_cast<{T}>(0);")
        lines.append(f"{body}for ({it} r = 0; r < {out_chunk[d]}; ++r) {{")
        self.lines, self.ind = [], inner
        x = src.at(idx)
        self._check_own_slot(m, self._tile_write(m, out_chunk, idx), "\n".join(self.lines) + x)
        lines += self.lines
        lines.append(f"{inner}acc += {x};")
        lines.append(f"{inner}const {T} v = {_c_round(m.dtype, 'acc')};")
        lines += self._writes(m, sched, out_chunk, idx, "v", inner)
        lines += [f"{body}}}", f"{ind}}}"]
        return lines

    def member_loop(self, m: Instruction, ind: str) -> List[str]:
        if m.opcode == "reduce":
            lines = self.reduce_loop(m, ind)
        elif m.opcode == "cumsum":
            lines = self.cumsum_loop(m, ind)
        elif m.opcode == "dot":
            lines = self.dot_loop(m, ind)
        else:
            lines = self.element_loop(m, ind)
        if m.id in self.restaged:
            # the second loop of a restaged member: every read of the slot's
            # previous owner is done, so its tile goes into the slot
            n = _prod(chunk_shape(m.shape, self.sched(m)))
            T, ptr = _c_type(m.dtype), self.tiles[m.id]
            self.stage_bytes = max(self.stage_bytes, n * np.dtype(m.dtype).itemsize)
            self.extent = max(self.extent, n + self.threads - 1)
            lines += [f"{ind}__syncthreads();  // the slot's previous owner is read: write {ptr}",
                      f"{ind}for ({self.itype} i = threadIdx.x; i < {n}; i += {self.threads}) "
                      f"{ptr}[i] = reinterpret_cast<const {T}*>(sx_stage)[i];"]
        return lines

    def emit(self) -> List[str]:
        pk, ph = self.pk, self.phase
        stored = [m for m in ph.members
                  if m.id in self.tiles or m.id in self.out_of or m.id in self.staged]
        held = [self._comment(m, "  ") for m in ph.members if m.id in self.held]
        if self.slot_base is None:
            head = (f"  // phase {pk}: {len(ph.members)} members, {self.blocks} plan blocks, "
                    "no slot: a pure map over the grid")
            out = [head] + held
            for m in stored:
                out.append(self._comment(m, "  "))
                out += self.member_loop(m, "  ")
            return out
        groups = [[m for m in stored if m.id in ids]
                  for ids in map(set, self.launch.groups or [[m.id for m in stored]])]
        groups = [g for g in groups if g]   # a group of constants read as literals
        head = f"  // phase {pk}: {len(ph.members)} members, {self.blocks} plan blocks over the grid, "
        if len(groups) > 1:
            head += f"{len(groups)} independent member groups a plan block, "
        out = [head + f"slots {self.launch.slot_bytes} bytes in {self.launch.slots_in}"] + held + ["  {"]
        for slot, ptr in sorted(self.slot_ptr.items()):
            T = _c_type(self.pplan.slots[slot][1])
            out.append(f"    {T}* const {ptr} = reinterpret_cast<{T}*>({self.slot_base} + "
                       f"{self.launch.slot_offsets[slot]});")
        it = self.itype
        if len(groups) == 1:
            self.strided.append((self.blocks, 1))
            out.append(f"    for ({it} b = blockIdx.x; b < {self.blocks}; b += gridDim.x) {{")
            for m in groups[0]:
                out.append(self._comment(m, "      "))
                out += self.member_loop(m, "      ")
                out.append("      __syncthreads();")
        else:
            # each (plan block, group) pair a unit of work, dealt over the grid
            units = self.blocks * len(groups)
            self.extent = max(self.extent, units)
            self.strided.append((units, 1))
            out.append(f"    for ({it} u = blockIdx.x; u < {units}; u += gridDim.x) {{")
            if self.blocks > 1:
                out.append(f"      const {it} b = u / {len(groups)};")
            for g, members in enumerate(groups):
                cond = f"u % {len(groups)} == {g}"
                out.append(f"      {'if' if g == 0 else '} else if'} ({cond}) {{")
                for m in members:
                    out.append(self._comment(m, "        "))
                    out += self.member_loop(m, "        ")
                    out.append("        __syncthreads();")
            out.append("      }")
        out += ["    }", "  }"]
        return out

    def _comment(self, m: Instruction, ind: str) -> str:
        sched = self.sched(m)
        what = m.opcode + "".join(f":{m.attrs[a]}" for a in ("fn", "kind") if a in m.attrs)
        ops = ", ".join(self.label[o.id] for o in m.operands)
        where = f" -> slot {self.tiles[m.id]}" if m.id in self.tiles else ""
        if m.id in self.held:
            slot = self.pplan.entries[m.id].slot
            where = f" -> held in a register where it is read, not in the plan's slot {slot}"
        return f"{ind}// {self.label[m.id]} = {what}({ops}) on tile {list(chunk_shape(m.shape, sched))}{where}"


def _cuda_stitched(fusion: FusedComputation, stitched: StitchedSolution,
                   plan: StitchedMemoryPlan, launches: Sequence[PhaseLaunch]):
    """The text of ``emit_stitched_fusion``'s kernel over ``plan``, each
    phase launched as ``launches`` (``geometry.stitched_launch``) says."""
    inputs, roots = fusion.inputs, fusion.roots
    members = {m.id: m for m in fusion.members}
    in_name = {i.id: f"in{k}" for k, i in enumerate(inputs)}
    label = {**in_name, **{m.id: f"m{k}" for k, m in enumerate(fusion.members)}}
    out_of = {r.id: (f"out{k}", tuple(r.shape)) for k, r in enumerate(roots)}
    threads = launches[0].threads
    ws = _Workspace()
    staged: Dict[int, str] = {}
    for k, iid in enumerate(plan.interfaces):
        m = members[iid]
        staged[iid] = ws.alloc(f"s{k}", m, m.shape, "ws", "  ")
    body = list(ws.decls)
    # slots: in shared memory where a phase's fit, else in a region of the
    # workspace for each CUDA block that runs one of the phase's plan blocks
    smem, region = 0, 0
    for phase, launch in zip(stitched.phases, launches, strict=True):
        if launch.slots_in == WORKSPACE:
            region = max(region, launch.slot_bytes * phase.solution.blocks)
        else:
            smem = max(smem, launch.slot_bytes)
    if smem:
        body.append("  extern __shared__ __align__(16) unsigned char sx_smem[];")
    head = list(body)

    def emit(wide: bool):
        body, phases = list(head), []
        for pk, (phase, pplan, launch) in enumerate(zip(stitched.phases, plan.phase_plans,
                                                        launches, strict=True)):
            if pk:
                body.append("  sx_grid_sync();")
            if launch.slots_in == WORKSPACE:
                body.append(f"  unsigned char* const pr{pk} = ws + {ws.size} + "
                            f"static_cast<size_t>(blockIdx.x) * {launch.slot_bytes};")
            ph = _Phase(pk, phase, pplan, launch, in_name, staged, out_of, label, wide=wide)
            body += ph.emit()
            phases.append(ph)
        return body, phases

    grid = max(launch.grid for launch in launches)
    body, phases = emit(False)
    if _wide(fusion, phases, grid):
        body, phases = emit(True)
    _count_map_loops(phases)
    static_smem = max([0] + [ph.part_bytes for ph in phases])
    stage = max([0] + [ph.stage_bytes for ph in phases])
    dots = max([0] + [launch.dot_offset + ph.dot_bytes
                      for ph, launch in zip(phases, launches, strict=True) if ph.dot_bytes])
    if dots > smem:
        if not smem:
            body.insert(len(ws.decls), "  extern __shared__ __align__(16) unsigned char sx_smem[];")
        smem = dots
    if static_smem:
        body.insert(0, f"  __shared__ __align__(16) unsigned char sx_part[{static_smem}];")
    total = ws.size + region + _stage_region(body, ws.size + region, stage, grid)
    header = (
        f"// emit_stitched_fusion: {stitched.num_phases} phases, {stitched.blocks} plan blocks "
        f"in all, one cooperative launch of up to {grid} blocks of {threads} threads, "
        f"{smem} bytes of shared memory a block, {total} workspace bytes"
        + _index_header(phases) + _dot_header(phases)
    )
    name, symbol, text = _finish_cooperative(header, body, inputs, roots, grid, threads, smem,
                                             static_smem, fusion_label(fusion.members),
                                             launches[0].blocks_per_sm)
    return name, symbol, text, total, smem + static_smem


def _stage_region(body: List[str], offset: int, stage: int, grid: int) -> int:
    """Declare ``sx_stage``, a block's staging region for restaged SHARE
    members (``_Phase._check_own_slot``), at ``offset`` in the workspace,
    one region of ``stage`` bytes a CUDA block; returns its bytes."""
    if not stage:
        return 0
    stage = -(-stage // SLOT_ALIGN) * SLOT_ALIGN
    body.insert(0, f"  unsigned char* const sx_stage = ws + {offset} + "
                   f"static_cast<size_t>(blockIdx.x) * {stage};")
    return stage * grid


def _finish_cooperative(header: str, body: List[str], inputs, roots, useful: int,
                        threads: int, smem: int, static_smem: int,
                        label: str, blocks: int = 1) -> Tuple[str, str, str]:
    """Name a stitched kernel (``_name_text``) and add its launcher: one
    cooperative launch of as many blocks as the card holds at once, at most
    ``useful``, the count asked once per device and cached; ``blocks`` an
    SM asked of the compiler (``PhaseLaunch.blocks_per_sm``)."""
    params, lparams, casts = _signature_c(inputs, roots, ws_restrict=False)
    n = len(casts)
    launcher = ['extern "C" int @K@_launch(']
    launcher += [f"    {p}," for p in lparams] + ["    void* stream) {"]
    launcher += [f"  {p.rsplit(' ', 1)[0].replace('__restrict__', '').strip()} a{k} = {c};"
                 for k, (p, c) in enumerate(zip(params, casts, strict=True))]
    launcher += [
        f"  static std::atomic<int> grids[{GRID_CACHE_DEVICES}];  // 0: not asked yet",
        "  int dev = 0;",
        "  cudaError_t e = cudaGetDevice(&dev);",
        "  if (e != cudaSuccess) return static_cast<int>(e);",
        f"  int grid = dev < {GRID_CACHE_DEVICES} ? grids[dev].load(std::memory_order_relaxed) : 0;",
        "  if (grid == 0) {",
    ]
    if smem + static_smem > STATIC_SMEM_LIMIT:
        launcher += [
            f"    e = cudaFuncSetAttribute(@K@, cudaFuncAttributeMaxDynamicSharedMemorySize, {smem});",
            "    if (e != cudaSuccess) return static_cast<int>(e);",
        ]
    launcher += [
        "    int sms = 0, per_sm = 0;",
        "    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);",
        "    if (e != cudaSuccess) return static_cast<int>(e);",
        f"    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, @K@, {threads}, {smem});",
        "    if (e != cudaSuccess) return static_cast<int>(e);",
        f"    grid = sms * per_sm < {useful} ? sms * per_sm : {useful};",
        "    if (grid < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);",
        f"    if (dev < {GRID_CACHE_DEVICES}) grids[dev].store(grid, std::memory_order_relaxed);",
        "  }",
        f"  void* args[] = {{{', '.join(f'&a{k}' for k in range(n))}}};",
        f"  e = cudaLaunchCooperativeKernel(@K@, dim3(grid), dim3({threads}), args, {smem}, "
        "static_cast<cudaStream_t>(stream));",
        "  if (e != cudaSuccess) return static_cast<int>(e);",
        "  return static_cast<int>(cudaGetLastError());",
        "}", "",
    ]
    text = "\n".join(
        [header, f"__global__ void {_bounds(threads, blocks)} @K@("]
        + [f"    {p}," for p in params[:-1]] + [f"    {params[-1]}) {{"]
        + body + ["}", ""] + launcher
    )
    return _name_text(text, label)


# --------------------------------------------------------------------------
# The kernel wrapper and the compiled-kernel record
# --------------------------------------------------------------------------


class KernelProgram:
    """One generated kernel: its CUDA source, its plain version, and the
    launch counter.  ``name`` is ``stitch_`` and the hash of its text, and
    binds its launcher ``<name>_launch``; ``symbol``, its ``__global__``
    function as the profiler names it, adds the fusion's label.  Calling it
    dispatches on the inputs' device: CPU tensors go to the plain version,
    CUDA tensors to the kernel, anything else raises.  A call with no inputs
    runs on ``device``, which defaults to the card.  ``launches`` counts
    kernel launches only.

    ``KernelProgram.launches_by_emitter`` tallies every program's
    ``launches`` by emitter: each change to one moves it by as much.  Set
    to 0 before a run and read after, it gives the run's generated-kernel
    launches, those of programs the run made and dropped included."""

    launches_by_emitter: Dict[str, int] = {"emit_fusion": 0, "emit_stitched_fusion": 0}

    def __init__(self, name: str, symbol: str, source: str, emitter: str, plain: Callable,
                 inputs: Sequence[Instruction], outputs: Sequence[Instruction],
                 workspace_bytes: int, shared_bytes: int = 0):
        self.name = name
        self.symbol = symbol
        self.source = source
        self.emitter = emitter
        self.plain = plain
        self.in_specs = [(tuple(i.shape), torch_dtype(i.dtype)) for i in inputs]
        self.out_specs = [(tuple(r.shape), torch_dtype(r.dtype)) for r in outputs]
        self.workspace_bytes = workspace_bytes
        self.shared_bytes = shared_bytes      # dynamic + static, a block
        self._launches = 0
        self._launch = None

    @property
    def launches(self) -> int:
        return self._launches

    @launches.setter
    def launches(self, n: int) -> None:
        tally = KernelProgram.launches_by_emitter
        tally[self.emitter] = tally.get(self.emitter, 0) + n - self._launches
        self._launches = n

    def load(self, lib: ctypes.CDLL) -> None:
        """Bind this kernel's launcher in a built library."""
        fn = getattr(lib, self.name + "_launch")
        fn.argtypes = [ctypes.c_void_p] * (len(self.in_specs) + len(self.out_specs) + 2)
        fn.restype = ctypes.c_int
        self._launch = fn

    def __call__(self, *args, device=None, out=None):
        """``out``, where given, holds one tensor or None per output: a
        tensor is written in place of a fresh one (a donated buffer of the
        output's shape and dtype, which the kernel does not read)."""
        dev = input_device(self.name, args) if args else resolve_device(device)
        if dev.type == "cpu":
            res = self.plain(*args, device=dev)
            if out is None:
                return res
            return tuple(r if o is None else o.copy_(r) for r, o in zip(res, out, strict=True))
        if out is None:
            return self.launch(*args, device=dev)
        return self.launch(*args, device=dev, out=out)

    def launch(self, *args, device, out=None) -> Tuple[torch.Tensor, ...]:
        if self._launch is None:
            raise RuntimeError(
                f"{self.name}: no CUDA library is loaded for this kernel "
                "(compile the module with device='cuda')"
            )
        if len(args) != len(self.in_specs):
            raise ValueError(f"{self.name}: {len(args)} inputs, expected {len(self.in_specs)}")
        if device.index not in (None, torch.cuda.current_device()):
            # the launcher runs in the current device's context
            raise ValueError(f"{self.name}: inputs on {device}, not the current device")
        for k, (a, (shape, dtype)) in enumerate(zip(args, self.in_specs, strict=True)):
            if tuple(a.shape) != shape or a.dtype != dtype:
                raise ValueError(
                    f"{self.name}: input {k} is {a.dtype}{list(a.shape)}, "
                    f"expected {dtype}{list(shape)}"
                )
        args = [a.contiguous() for a in args]
        outs = list(out) if out is not None else [None] * len(self.out_specs)
        for k, ((shape, dtype), o) in enumerate(zip(self.out_specs, outs, strict=True)):
            if o is None:
                outs[k] = torch.empty(shape, dtype=dtype, device=device)
            elif tuple(o.shape) != shape or o.dtype != dtype or o.device.type != device.type \
                    or not o.is_contiguous():
                raise ValueError(
                    f"{self.name}: out {k} is {o.dtype}{list(o.shape)} on {o.device}, "
                    f"expected a contiguous {dtype}{list(shape)} on {device}"
                )
        ws = torch.empty(max(self.workspace_bytes, 1), dtype=torch.uint8, device=device)
        rc = self._launch(
            *[a.data_ptr() for a in args], *[o.data_ptr() for o in outs],
            ws.data_ptr(), torch.cuda.current_stream(device).cuda_stream,
        )
        if rc != 0:
            raise RuntimeError(f"{self.name}: kernel launch failed with cudaError {rc}")
        self.launches += 1
        return tuple(outs)


@dataclass
class StitchedKernel:
    """A compiled stitched kernel: call with input tensors in ``inputs`` order.

    Single-phase kernels carry a ``solution``; multi-phase stitched kernels
    carry a ``stitched`` solution instead and ``solution`` is None.  ``fn``
    is the ``KernelProgram`` that every instance bound to it shares.
    """

    fusion: FusedComputation
    solution: Optional[ScheduleSolution]
    plan: object                         # MemoryPlan | StitchedMemoryPlan
    fn: KernelProgram
    inputs: List[Instruction]
    outputs: List[Instruction]
    stitched: Optional[StitchedSolution] = None

    @property
    def blocks(self) -> int:
        if self.stitched is not None:
            return self.stitched.blocks
        return self.solution.blocks

    @property
    def num_phases(self) -> int:
        return self.stitched.num_phases if self.stitched is not None else 1

    def __call__(self, *args, device=None, out=None):
        if out is None:
            return self.fn(*args, device=device)
        return self.fn(*args, device=device, out=out)

    def bind(self, fusion: FusedComputation) -> "StitchedKernel":
        """Re-bind this kernel to a structurally-identical fusion instance
        (same fusion signature): only the argument/result lists change."""
        return StitchedKernel(
            fusion, self.solution, self.plan, self.fn,
            fusion.inputs, fusion.roots, stitched=self.stitched,
        )


def emit_fusion(
    fusion: FusedComputation,
    solution: ScheduleSolution,
    plan: MemoryPlan,
) -> StitchedKernel:
    """One schedule-consistent fusion as one CUDA launch that follows
    ``plan``: ALLOC/SHARE members in its slots in shared memory (or a
    per-block workspace region past ``geometry.SMEM_LIMIT``), INLINE members composed
    into their consumers, a CUDA block per plan block and independent member
    group, cooperative reduces (module docstring), launched as
    ``geometry.fusion_launch`` decides."""
    _check_no_collectives(fusion)
    name, symbol, source, ws, shared = _cuda_fusion(
        fusion, solution, plan, fusion_launch(fusion.members, fusion.roots, solution, plan))
    program = KernelProgram(
        name, symbol, source, "emit_fusion", _plain_fusion(fusion, solution),
        fusion.inputs, fusion.roots, ws, shared,
    )
    return StitchedKernel(fusion, solution, plan, program, fusion.inputs, fusion.roots)


def emit_stitched_fusion(
    fusion: FusedComputation,
    stitched: StitchedSolution,
    plan: StitchedMemoryPlan,
) -> StitchedKernel:
    """Every phase of a stitched group in ONE cooperative CUDA launch over
    the grid, with the plan's slots in shared memory (module docstring),
    each phase launched as ``geometry.stitched_launch`` decides."""
    _check_no_collectives(fusion)
    name, symbol, source, ws, shared = _cuda_stitched(fusion, stitched, plan,
                                                      stitched_launch(stitched, plan))
    program = KernelProgram(
        name, symbol, source, "emit_stitched_fusion", _plain_stitched(fusion, stitched, plan),
        fusion.inputs, fusion.roots, ws, shared,
    )
    return StitchedKernel(
        fusion, None, plan, program, fusion.inputs, fusion.roots, stitched=stitched
    )


def assemble_source(programs: Sequence[KernelProgram]) -> str:
    """One translation unit holding every unique kernel of a compile."""
    seen, parts = set(), ['#include "stitch_runtime.cuh"', ""]
    for p in programs:
        if p.name not in seen:
            seen.add(p.name)
            parts.append(p.source)
    return "\n".join(parts)
