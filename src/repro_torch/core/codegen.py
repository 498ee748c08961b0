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
    map whose elements stride over the whole grid.  Reduces are
    cooperative: a warp per output element, shuffles to combine (the
    whole block where a plan block has fewer outputs than warps).
    Interface tensors are staged whole in the global workspace —
    StitchPipe's alone is 655,360 bytes, more than one block's 227 KB of
    shared memory — and re-tiled by their consumer phases.

Design of ``emit_fusion``: one launch of the same phase emitter
(``_Phase``) the stitched kernel runs each phase through, over the
fusion's ``MemoryPlan``.  ALLOC/SHARE members live in the plan's slots, in
dynamic shared memory at the plan's offsets (past ``SMEM_LIMIT``, in a
per-block region of the workspace); INLINE members are composed into their
consumers and write nothing; outputs are written straight to ``out*``.  A
plan block's members run in order, each a fixed-count unrolled loop over
its tile with a barrier after it.  Members that share no value form groups
(``_independent_groups``), and each (plan block, group) pair runs on a
CUDA block of its own: ReduceTowers' six towers on six SMs.  A reduce
takes a warp per output, or, where a plan block has fewer outputs than
warps, the whole block, partial results combined through shared memory.
A fused dot gives each thread a 4 x 4 register tile of outputs with f32
FMAs (no tensor cores, no TF32).  A fusion with no slot is a pure map over
the grid.  Threads per block follow the plan (``fusion_threads``: 128 to
512).  At these sizes what bounds the kernels on the card is latency: the
launch, and the dependent loads and barriers between members.

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
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .device import input_device, resolve_device
from .fusion import FusedComputation
from .ir import (
    BFLOAT16,
    Instruction,
    apply_op,
    as_array,
    broadcast_in_dim,
    dtype_name,
    iota,
    torch_dtype,
)
from .memory import ALLOC, SHARE, MemoryPlan, StitchedMemoryPlan
from .schedule import (
    REPLICATED,
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

#: threads per block of a kernel (``stitched_threads``, ``fusion_threads``)
STITCHED_MIN_THREADS, STITCHED_MAX_THREADS = 128, 512
STITCHED_ELEMS_PER_THREAD = 16
#: shared memory one H100 block may use (dynamic, past 48 KB only after
#: cudaFuncSetAttribute); slots of a phase that need more live in the workspace
SMEM_LIMIT = 232_448
STATIC_SMEM_LIMIT = 48 * 1024
GRID_CACHE_DEVICES = 16   # devices whose cooperative grid a launcher caches
_ALIGN = 16


def _prod(xs: Sequence[int]) -> int:
    out = 1
    for x in xs:
        out *= int(x)
    return out


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
                        for o, ns in zip(m.operands, propagate(m, sched), strict=False)
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
                        for o, ns in zip(m.operands, propagate(m, sched), strict=False):
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


def _c_types(dtype) -> Tuple[str, str]:
    try:
        return _C_TYPES[np.dtype(dtype)]
    except KeyError:
        raise NotImplementedError(
            f"the CUDA emitters take {sorted(dtype_name(d) for d in _C_TYPES)}, "
            f"not {dtype_name(dtype)}"
        ) from None


def _c_type(dtype) -> str:
    """The C type of a ``dtype`` value in memory."""
    return _c_types(dtype)[0]


def _c_compute(dtype) -> str:
    """The C type a ``dtype`` value is computed in."""
    return _c_types(dtype)[1]


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
    needs is ``ptr[sum((offs[k] + idx[k]) * strides[k])]``, read as a
    ``dtype`` value in the type it is computed in, or a literal."""

    shape: Tuple[int, ...]
    ptr: str = ""
    strides: Tuple[int, ...] = ()
    offs: Tuple = ()
    literal: str = ""
    dtype: object = np.float32

    def at(self, idx) -> str:
        return self.literal or _c_load(self.dtype, self.ref(idx))

    def ref(self, idx) -> str:
        """The element itself, as stored: what a write assigns to."""
        ints, parts = 0, []
        for o, j, s in zip(self.offs, idx, self.strides, strict=True):
            t = _cmul(_cadd(o, j), s)
            if isinstance(t, int):
                ints += t
            else:
                parts.append(t)
        if ints or not parts:
            parts.append(str(ints))
        return f"{self.ptr}[{' + '.join(parts)}]"


def _unravel(lines: List[str], var: str, shape, prefix: str, ind: str) -> List:
    """Emit statements splitting linear index ``var`` over ``shape``."""
    idx: List = [0] * len(shape)
    dims = [k for k, s in enumerate(shape) if s != 1]
    if not dims:
        return idx
    rem = f"{prefix}_rem"
    lines.append(f"{ind}int {rem} = {var};")
    for k in reversed(dims):
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
           lines: List[str], ind: str, lin: str = "i", sfx: str = "") -> str:
    """Emit the statements computing element ``idx`` of ``m``'s tile and
    return the C expression of its value, in the type ``m`` computes in and
    not yet rounded to ``m.dtype`` (the reference's ``_emit_instr`` and
    ``apply_op``, per element; reduces and dots have loops of their own).
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
        j = _unravel(lines, lin, ovs[0].shape, f"p{sfx}", ind)
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
               full: bool) -> _View:
    """The reference's ``_adapt`` as a view: ``full`` arrays (kernel inputs,
    staged interfaces) hold the whole tensor; tiles hold the stored chunk."""
    dt = opnd.dtype
    if stored == needed:
        if full and stored.kind == "chunked":
            return _View(chunk_shape(opnd.shape, stored), name, _dense_strides(opnd.shape),
                         _c_starts(opnd.shape, stored, b), dtype=dt)
        return _View(tuple(shape), name, _dense_strides(shape), (0,) * len(shape), dtype=dt)
    if stored.kind == "replicated" and needed.kind == "chunked":
        return _View(chunk_shape(opnd.shape, needed), name, _dense_strides(opnd.shape),
                     _c_starts(opnd.shape, needed, b), dtype=dt)
    raise ValueError(f"cannot adapt {opnd.name}: stored {stored}, needed {needed}")


def _literal_view(m: Instruction, needed: Sched) -> _View:
    return _View(chunk_shape(m.shape, needed),
                 literal=_c_load(m.dtype, _c_literal(m.attrs["value"], m.dtype)))


class _Workspace:
    """Byte offsets of the arrays a kernel keeps in its global workspace."""

    def __init__(self):
        self.size = 0
        self.decls: List[str] = []

    def alloc(self, name: str, instr: Instruction, shape, base: str, ind: str) -> str:
        off = self.size
        self.size += -(-_prod(shape) * np.dtype(instr.dtype).itemsize // _ALIGN) * _ALIGN
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


def _finish_source(header: str, body: List[str], inputs, roots, grid: int,
                   threads: int, smem: int, static_smem: int) -> Tuple[str, str]:
    """Name a single-phase kernel by the hash of its text and add its
    launcher: one launch of ``grid`` blocks with ``smem`` bytes of dynamic
    shared memory (where they and the ``static_smem`` bytes pass 48 KB,
    the attribute is set once per device)."""
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
        [header, f"__global__ void __launch_bounds__({threads}) @K@("]
        + [f"    {p}," for p in params[:-1]] + [f"    {params[-1]}) {{"]
        + body + ["}", ""] + launcher
    )
    name = "stitch_" + hashlib.sha256(text.encode()).hexdigest()[:16]
    return name, text.replace("@K@", name)


def _independent_groups(fusion: FusedComputation) -> List[List[int]]:
    """The member ids of a fusion split into groups that share no value
    (constants, read as literals, join none), each in topological order,
    the groups in the order of their first member.  No group reads what
    another writes, so each may run on a CUDA block of its own."""
    parent = {m.id: m.id for m in fusion.members}

    def find(x: int) -> int:
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for m in fusion.members:
        if m.opcode == "constant":
            continue
        for o in m.operands:
            if o.id in parent and o.opcode != "constant":
                parent[find(o.id)] = find(m.id)
    groups: Dict[int, List[int]] = {}
    for m in fusion.members:
        groups.setdefault(find(m.id), []).append(m.id)
    return list(groups.values())


def _cuda_fusion(fusion: FusedComputation, solution: ScheduleSolution, plan: MemoryPlan):
    inputs, roots = fusion.inputs, fusion.roots
    in_name = {i.id: f"in{k}" for k, i in enumerate(inputs)}
    label = {**in_name, **{m.id: f"m{k}" for k, m in enumerate(fusion.members)}}
    out_of = {r.id: (f"out{k}", tuple(r.shape)) for k, r in enumerate(roots)}
    threads = fusion_threads(fusion, solution, plan)
    _, size = _slot_layout(plan)
    base, groups = None, None
    if plan.slots:
        # shared memory holds the slots and the block reduces' partials
        base = "sx_smem" if size + reduce_part_bytes(threads) <= SMEM_LIMIT else "pr0"
        groups = _independent_groups(fusion)
    ph = _Phase(0, PhaseSolution(fusion.members, roots, solution), plan, threads,
                in_name, {}, out_of, label, base, groups)
    phase = ph.emit()
    grid = max(1, ph.useful_blocks)
    body = []
    if base == "sx_smem":
        body.append("  extern __shared__ __align__(16) unsigned char sx_smem[];")
    elif base is not None:
        body.append(f"  unsigned char* const pr0 = ws + static_cast<size_t>(blockIdx.x) * {size};")
    if ph.part_bytes:
        body.append(f"  __shared__ __align__(16) unsigned char sx_part[{ph.part_bytes}];")
    body += phase
    smem = size if base == "sx_smem" else 0
    ws = size * grid if base == "pr0" else 0
    ws += _stage_region(body, ws, ph.stage_bytes, grid)
    header = (
        f"// emit_fusion: {len(fusion.members)} members, {solution.blocks} plan blocks, "
        f"one launch of {grid} blocks of {threads} threads, {smem} bytes of shared memory "
        f"a block, {ws} workspace bytes"
    )
    name, text = _finish_source(header, body, inputs, roots, grid, threads, smem, ph.part_bytes)
    return name, text, ws, smem + ph.part_bytes


def _slot_layout(pplan: MemoryPlan) -> Tuple[List[int], int]:
    """Byte offsets of a phase plan's slots, each 16-byte aligned, and
    their total: the shared memory (or per-block workspace region) the
    phase's ALLOC/SHARE members live in."""
    offs, size = [], 0
    for shape, dtype in pplan.slots:
        offs.append(size)
        size += -(-_prod(shape) * np.dtype(dtype).itemsize // _ALIGN) * _ALIGN
    return offs, size


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


def fusion_threads(fusion: FusedComputation, solution: ScheduleSolution, plan: MemoryPlan) -> int:
    """Threads of each block of a single-phase kernel, from its plan: the
    fewest, from 128 up to 512, that leave every loop of a plan block (each
    member that writes a slot or an output) at most
    ``STITCHED_ELEMS_PER_THREAD`` elements, or a reduce's terms, a thread,
    and give every reduce output a warp."""
    roots = {r.id for r in fusion.roots}
    want = 1
    for m in fusion.members:
        e = plan.entries.get(m.id)
        kept = m.id in roots or (e is not None and e.action in (ALLOC, SHARE))
        if m.opcode == "constant" or not kept:
            continue
        sched = solution.assignment[m.id]
        n = _prod(chunk_shape(m.shape, sched))
        if m.opcode == "reduce":
            (ns,) = propagate(m, sched)
            terms = _prod(chunk_shape(m.operands[0].shape, ns))
            want = max(want, 32 * n, -(-terms // STITCHED_ELEMS_PER_THREAD))
        else:
            want = max(want, -(-n // STITCHED_ELEMS_PER_THREAD))
    return _threads_for(want)


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


def _counted_loop(var: str, first: str, step: int, n: int, ind: str) -> List[str]:
    """The head of a loop of ``var`` over ``first, first + step, ...`` below
    ``n`` as a loop of a fixed count, unrolled, so a thread issues all its
    iterations' loads before it waits for the first."""
    count = -(-n // step)
    lines = [f"{ind}#pragma unroll" + ("" if count <= 32 else " 8"),
             f"{ind}for (int {var}k = 0; {var}k < {count}; ++{var}k) {{",
             f"{ind}  const int {var} = {first} + {var}k * {step};"]
    if n % step:
        lines.append(f"{ind}  if ({var} >= {n}) break;")
    return lines


class _Lazy:
    """An INLINE member read where its consumer needs it: ``at(idx)``
    composes the member's value at ``idx`` into the consumer's expression,
    so no tile is written for it.  Reduces and dots are never INLINE where
    they have a user (the memory plan requires their buffers)."""

    def __init__(self, phase: "_Phase", m: Instruction, stored: Sched, needed: Sched, b):
        self.phase, self.m, self.stored, self.needed, self.b = phase, m, stored, needed, b
        self.shape = chunk_shape(m.shape, needed)

    def at(self, idx) -> str:
        m, b = self.m, self.b
        if self.stored == self.needed:
            sched, j = self.stored, list(idx)
        elif self.stored.kind == "replicated" and self.needed.kind == "chunked":
            sched = REPLICATED
            j = [_cadd(s, i) for s, i in zip(_c_starts(m.shape, self.needed, b), idx, strict=True)]
        else:
            raise ValueError(f"cannot adapt {m.name}: stored {self.stored}, needed {self.needed}")
        if m.opcode in ("reduce", "dot"):
            raise ValueError(f"{m.name}: an INLINE {m.opcode} with a user has no buffer to read")
        return self.phase.value(m, sched, j, _lin(j, chunk_shape(m.shape, sched)), self.phase.fresh())


class _Phase:
    """The CUDA text of one phase: a phase of a stitched kernel, or the
    single phase of an ``emit_fusion`` kernel.  ``slot_base`` names where
    the plan's ALLOC/SHARE slots live (None: the phase has no slot and is a
    pure map over the grid).  ``groups``, for a single-phase kernel with
    slots, splits the members into independent groups (``_independent_groups``),
    each run by a CUDA block of its own for each plan block."""

    def __init__(self, pk: int, phase, pplan: MemoryPlan, threads: int, in_name, staged, out_of,
                 label, slot_base: Optional[str], groups: Optional[List[List[int]]] = None):
        self.pk, self.phase, self.pplan, self.threads = pk, phase, pplan, threads
        self.assign = phase.solution.assignment
        self.blocks = phase.solution.blocks
        self.b = _Sym("b") if self.blocks > 1 else 0
        self.in_name, self.staged, self.out_of, self.label = in_name, staged, out_of, label
        self.ids = {m.id for m in phase.members}
        self.const_ids = {m.id for m in phase.members if m.opcode == "constant"}
        self.offs, self.slot_bytes = _slot_layout(pplan)
        self.slot_base = slot_base            # None: a pure map, no slot
        self.groups = groups
        self.slot_ptr: Dict[int, str] = {}    # slot index -> pointer name
        self.tiles: Dict[int, str] = {}       # ALLOC/SHARE member -> its slot
        for m in phase.members:
            e = pplan.entries.get(m.id)
            if e is not None and e.action in (ALLOC, SHARE) and m.id not in self.const_ids:
                self.slot_ptr.setdefault(e.slot, f"p{pk}s{e.slot}")
                self.tiles[m.id] = self.slot_ptr[e.slot]
        self.lines: List[str] = []
        self.ind = ""
        self.n = 0
        self.useful_blocks = 0  # the most blocks this phase's loops keep busy
        self.part_bytes = 0     # static shared memory of the block-wide reduces
        self.restaged: set = set()   # SHARE members that write through sx_stage
        self.stage_bytes = 0    # the largest tile written through sx_stage

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
            return _tile_view(self.tiles[o.id], chunk_shape(o.shape, st), st, ns, o, self.b, full=False)
        if o.id in self.ids:
            return _Lazy(self, o, self.assign[o.id], ns, self.b)
        # kernel input or staged interface: stored whole
        src = self.in_name[o.id] if o.id in self.in_name else self.staged[o.id]
        return _tile_view(src, o.shape, REPLICATED, ns, o, self.b, full=True)

    def value(self, m: Instruction, sched: Sched, idx, lin: str, sfx: str) -> str:
        """Element ``idx`` of ``m``, rounded to its dtype where it ends."""
        ovs = [self.view(o, ns) for o, ns in zip(m.operands, propagate(m, sched), strict=False)]
        expr = _value(m, sched, ovs, idx, self.b, self.lines, self.ind, lin=lin, sfx=sfx)
        return _c_round(m.dtype, expr)

    # ---- the loops ---------------------------------------------------------
    def _stores(self, m: Instruction, sched: Sched, idx, v: str) -> List[str]:
        """The fusion outputs and staged interfaces ``m`` writes."""
        dests = [self.out_of[m.id]] if m.id in self.out_of else []
        if m.id in self.staged:
            dests.append((self.staged[m.id], tuple(m.shape)))
        offs = _c_starts(m.shape, sched, self.b)
        out_chunk = chunk_shape(m.shape, sched)
        return [f"{_View(out_chunk, p, _dense_strides(full), offs).ref(idx)} = {_c_store(m.dtype, v)};"
                for p, full in dests]

    def _tile_write(self, m: Instruction, out_chunk, idx) -> Optional[str]:
        if m.id not in self.tiles:
            return None
        ptr = self.tiles[m.id]
        if m.id in self.restaged:
            ptr = f"reinterpret_cast<{_c_type(m.dtype)}*>(sx_stage)"
        return _View(out_chunk, ptr, _dense_strides(out_chunk), (0,) * len(out_chunk)).ref(idx)

    def _check_own_slot(self, m: Instruction, write: Optional[str], text: str) -> None:
        """A SHARE member may write its slot in place only where it reads
        its slot's previous owner (through the values composed into it) at
        no other element than the one the same thread then writes.  Where
        it reads another element (a transposed or reversed read), another
        thread could already have overwritten that one, so the member writes
        its tile to a staging region of the workspace instead (``sx_stage``),
        and after a block barrier the tile is copied into the slot
        (``member_loop``)."""
        if write is None:
            return
        ptr = self.tiles[m.id]
        mine = _indices(write, ptr)
        if any(i != mine[0] for i in _indices(text, ptr)):
            self.restaged.add(m.id)

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
        th = self.threads
        if self.slot_base is not None:
            return _counted_loop(var, "threadIdx.x", th, n, ind)
        reps = self.blocks if sched.kind == "chunked" else 1
        total = n * reps
        body = ind + "  "
        lines = [f"{ind}for (int t = blockIdx.x * {th} + threadIdx.x; t < {total}; "
                 f"t += gridDim.x * {th}) {{"]
        if reps > 1:
            lines.append(f"{body}const int b = t / {n};")
            lines.append(f"{body}const int {var} = t % {n};")
        else:
            lines.append(f"{body}const int {var} = t;")
        self.useful_blocks = max(self.useful_blocks, -(-total // th))
        return lines

    def element_loop(self, m: Instruction, ind: str) -> List[str]:
        sched = self.sched(m)
        out_chunk = chunk_shape(m.shape, sched)
        body = ind + "  "
        lines = self._loop_head("i", _prod(out_chunk), sched, ind)
        self.lines, self.ind = [], body
        idx = _unravel(self.lines, "i", out_chunk, "o", body)
        expr = self.value(m, sched, idx, "i", "")
        stmts = self.lines
        self._check_own_slot(m, self._tile_write(m, out_chunk, idx), "\n".join(stmts) + expr)
        lines += stmts
        lines.append(f"{body}const {_c_compute(m.dtype)} v = {expr};")
        lines += self._writes(m, sched, out_chunk, idx, "v", body)
        lines.append(f"{ind}}}")
        return lines

    def dot_loop(self, m: Instruction, ind: str) -> List[str]:
        """A fused dot: each thread a register tile of up to 4 x 4 outputs
        (rows and columns strided by the tile's count of them, so the
        lanes of a warp read neighbouring columns and rows), so each k
        loads 4 + 4 operands for 16 FMAs.  f32 FMAs in the reference's order
        of k, no tensor cores (the 2e-5 tolerance forbids TF32)."""
        sched = self.sched(m)
        out_chunk = chunk_shape(m.shape, sched)
        rows, cols = out_chunk[-2], out_chunk[-1]
        rm = next(r for r in (4, 2, 1) if rows % r == 0)
        rn = next(r for r in (4, 2, 1) if cols % r == 0)
        gshape = tuple(out_chunk[:-2]) + (rows // rm, cols // rn)
        T = _c_compute(m.dtype)
        body = ind + "  "
        lines = self._loop_head("i", _prod(gshape), sched, ind)
        self.lines, self.ind = [], body
        g = _unravel(self.lines, "i", gshape, "o", body)
        ms = [_cadd(g[-2], r * (rows // rm)) for r in range(rm)]
        ns = [_cadd(g[-1], c * (cols // rn)) for c in range(rn)]
        lhs, rhs = [self.view(o, ns_) for o, ns_ in zip(m.operands, propagate(m, sched), strict=False)]
        depth = lhs.shape[-1]
        self.lines.append(f"{body}{T} acc[{rm * rn}] = {{}};")
        self.lines.append(f"{body}#pragma unroll" + ("" if depth <= 32 else " 8"))
        self.lines.append(f"{body}for (int k = 0; k < {depth}; ++k) {{")
        self.ind = body + "  "
        for r, row in enumerate(ms):
            self.lines.append(f"{body}  const {T} a{r} = {lhs.at(list(g[:-2]) + [row, 'k'])};")
        for c, col in enumerate(ns):
            self.lines.append(f"{body}  const {T} c{c} = {rhs.at(list(g[:-2]) + ['k', col])};")
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
        (src,) = [self.view(o, ns) for o, ns in zip(m.operands, propagate(m, sched), strict=False)]
        rdims = tuple(m.attrs["dims"])
        kind = m.attrs["kind"]
        kept = [k for k in range(len(src.shape)) if k not in rdims]
        extent = [src.shape[k] for k in rdims]
        reps = self.blocks if pure and sched.kind == "chunked" else 1
        body = ind + "  "
        lines = []
        if pure:
            total = r_out * reps
            lines.append(f"{ind}for (int ow = (blockIdx.x * {th} + threadIdx.x) >> 5; ow < {total}; "
                         f"ow += (gridDim.x * {th}) >> 5) {{")
            if reps > 1:
                lines.append(f"{body}const int b = ow / {r_out};")
                lines.append(f"{body}const int o = ow % {r_out};")
            else:
                lines.append(f"{body}const int o = ow;")
            self.useful_blocks = max(self.useful_blocks, -(-total * 32 // th))
        self.lines, self.ind = [], body
        idx = _unravel(self.lines, "o", out_chunk, "o", body)
        j: List = [0] * len(src.shape)
        for kk, k in enumerate(kept):
            j[k] = idx[kk]
        self.lines.append(f"{body}{T} acc = {_REDUCE_INIT[kind].format(T=T)};")
        self.lines += _counted_loop("r", "(threadIdx.x & 31)", 32, _prod(extent), body)
        self.ind = body + "  "
        for k, q in zip(rdims, _unravel(self.lines, "r", extent, "q", body + "  "), strict=True):
            j[k] = q
        self.lines.append(f"{body}  {_REDUCE_STEP[kind].format(x=src.at(j))}")
        self.lines.append(f"{body}}}")
        self.lines.append(f"{body}acc = sx_warp_allreduce(acc, {_REDUCE_COMBINE[kind]}());")
        self.ind = body
        v = f"(acc / static_cast<{T}>({_prod(extent)}))" if kind == "mean" else "acc"
        stmts = self.lines
        self._check_own_slot(m, self._tile_write(m, out_chunk, idx), "\n".join(stmts))
        if not pure:
            lines.append(f"{ind}for (int o = threadIdx.x >> 5; o < {r_out}; o += {warps}) {{")
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
        (src,) = [self.view(o, ns) for o, ns in zip(m.operands, propagate(m, sched), strict=False)]
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
        self.lines, self.ind = [], inner
        idx = _unravel(self.lines, "o", out_chunk, "o", inner)
        j: List = [0] * len(src.shape)
        for kk, k in enumerate(kept):
            j[k] = idx[kk]
        self.lines += _counted_loop("r", "((threadIdx.x & 31) + 32 * p)", 32 * parts, _prod(extent), inner)
        self.ind = inner + "  "
        for k, q in zip(rdims, _unravel(self.lines, "r", extent, "q", inner + "  "), strict=True):
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
        idx = _unravel(lines, "o", out_chunk, "o", inner)
        v = f"(tot / static_cast<{T}>({_prod(extent)}))" if kind == "mean" else "tot"
        lines.append(f"{inner}const {T} v = {_c_round(m.dtype, v)};")
        lines += self._writes(m, sched, out_chunk, idx, "v", inner)
        lines += [f"{body}}}", f"{ind}}}"]
        return lines

    def member_loop(self, m: Instruction, ind: str) -> List[str]:
        if m.opcode == "reduce":
            lines = self.reduce_loop(m, ind)
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
            lines += [f"{ind}__syncthreads();  // the slot's previous owner is read: write {ptr}",
                      f"{ind}for (int i = threadIdx.x; i < {n}; i += {self.threads}) "
                      f"{ptr}[i] = reinterpret_cast<const {T}*>(sx_stage)[i];"]
        return lines

    def emit(self) -> List[str]:
        pk, ph = self.pk, self.phase
        stored = [m for m in ph.members
                  if m.id in self.tiles or m.id in self.out_of or m.id in self.staged]
        if self.slot_base is None:
            head = (f"  // phase {pk}: {len(ph.members)} members, {self.blocks} plan blocks, "
                    "no slot: a pure map over the grid")
            out = [head]
            for m in stored:
                out.append(self._comment(m, "  "))
                out += self.member_loop(m, "  ")
            return out
        groups = [[m for m in stored if m.id in ids]
                  for ids in map(set, self.groups or [[m.id for m in stored]])]
        groups = [g for g in groups if g]   # a group of constants read as literals
        where = "shared memory" if self.slot_base == "sx_smem" else "a per-block workspace region"
        head = f"  // phase {pk}: {len(ph.members)} members, {self.blocks} plan blocks over the grid, "
        if len(groups) > 1:
            head += f"{len(groups)} independent member groups a plan block, "
        out = [head + f"slots {self.slot_bytes} bytes in {where}", "  {"]
        for slot, ptr in sorted(self.slot_ptr.items()):
            T = _c_type(self.pplan.slots[slot][1])
            out.append(f"    {T}* const {ptr} = reinterpret_cast<{T}*>({self.slot_base} + {self.offs[slot]});")
        if len(groups) == 1:
            out.append(f"    for (int b = blockIdx.x; b < {self.blocks}; b += gridDim.x) {{")
            for m in groups[0]:
                out.append(self._comment(m, "      "))
                out += self.member_loop(m, "      ")
                out.append("      __syncthreads();")
        else:
            # each (plan block, group) pair a unit of work, dealt over the grid
            units = self.blocks * len(groups)
            out.append(f"    for (int u = blockIdx.x; u < {units}; u += gridDim.x) {{")
            if self.blocks > 1:
                out.append(f"      const int b = u / {len(groups)};")
            for g, members in enumerate(groups):
                cond = f"u % {len(groups)} == {g}"
                out.append(f"      {'if' if g == 0 else '} else if'} ({cond}) {{")
                for m in members:
                    out.append(self._comment(m, "        "))
                    out += self.member_loop(m, "        ")
                    out.append("        __syncthreads();")
            out.append("      }")
        out += ["    }", "  }"]
        self.useful_blocks = max(self.useful_blocks, self.blocks * len(groups))
        return out

    def _comment(self, m: Instruction, ind: str) -> str:
        sched = self.sched(m)
        what = m.opcode + "".join(f":{m.attrs[a]}" for a in ("fn", "kind") if a in m.attrs)
        ops = ", ".join(self.label[o.id] for o in m.operands)
        where = f" -> slot {self.tiles[m.id]}" if m.id in self.tiles else ""
        return f"{ind}// {self.label[m.id]} = {what}({ops}) on tile {list(chunk_shape(m.shape, sched))}{where}"


def _cuda_stitched(fusion: FusedComputation, stitched: StitchedSolution,
                   plan: StitchedMemoryPlan):
    inputs, roots = fusion.inputs, fusion.roots
    members = {m.id: m for m in fusion.members}
    in_name = {i.id: f"in{k}" for k, i in enumerate(inputs)}
    label = {**in_name, **{m.id: f"m{k}" for k, m in enumerate(fusion.members)}}
    out_of = {r.id: (f"out{k}", tuple(r.shape)) for k, r in enumerate(roots)}
    threads = stitched_threads(plan)
    ws = _Workspace()
    staged: Dict[int, str] = {}
    for k, iid in enumerate(plan.interfaces):
        m = members[iid]
        staged[iid] = ws.alloc(f"s{k}", m, m.shape, "ws", "  ")
    body = list(ws.decls)
    # slots: in shared memory where a phase's fit, else in a region of the
    # workspace for each CUDA block that runs one of the phase's plan blocks
    smem, region = 0, 0
    for pplan, phase in zip(plan.phase_plans, stitched.phases, strict=True):
        _, size = _slot_layout(pplan)
        if size <= SMEM_LIMIT:
            smem = max(smem, size)
        else:
            region = max(region, size * phase.solution.blocks)
    if smem:
        body.append("  extern __shared__ __align__(16) unsigned char sx_smem[];")
    grid, static_smem, stage = 1, 0, 0
    for pk, (phase, pplan) in enumerate(zip(stitched.phases, plan.phase_plans, strict=True)):
        if pk:
            body.append("  sx_grid_sync();")
        _, size = _slot_layout(pplan)
        base = None
        if pplan.slots:
            base = "sx_smem" if size <= SMEM_LIMIT else f"pr{pk}"
            if base != "sx_smem":
                body.append(f"  unsigned char* const {base} = ws + {ws.size} + "
                            f"static_cast<size_t>(blockIdx.x) * {size};")
        ph = _Phase(pk, phase, pplan, threads, in_name, staged, out_of, label, base)
        body += ph.emit()
        grid = max(grid, ph.useful_blocks)
        static_smem = max(static_smem, ph.part_bytes)
        stage = max(stage, ph.stage_bytes)
    if static_smem:
        body.insert(0, f"  __shared__ __align__(16) unsigned char sx_part[{static_smem}];")
    total = ws.size + region + _stage_region(body, ws.size + region, stage, grid)
    header = (
        f"// emit_stitched_fusion: {stitched.num_phases} phases, {stitched.blocks} plan blocks "
        f"in all, one cooperative launch of up to {grid} blocks of {threads} threads, "
        f"{smem} bytes of shared memory a block, {total} workspace bytes"
    )
    name, text = _finish_cooperative(header, body, inputs, roots, grid, threads, smem, static_smem)
    return name, text, total, smem + static_smem


def _stage_region(body: List[str], offset: int, stage: int, grid: int) -> int:
    """Declare ``sx_stage``, a block's staging region for restaged SHARE
    members (``_Phase._check_own_slot``), at ``offset`` in the workspace,
    one region of ``stage`` bytes a CUDA block; returns its bytes."""
    if not stage:
        return 0
    stage = -(-stage // _ALIGN) * _ALIGN
    body.insert(0, f"  unsigned char* const sx_stage = ws + {offset} + "
                   f"static_cast<size_t>(blockIdx.x) * {stage};")
    return stage * grid


def _finish_cooperative(header: str, body: List[str], inputs, roots, useful: int,
                        threads: int, smem: int, static_smem: int) -> Tuple[str, str]:
    """Name a stitched kernel by the hash of its text and add its launcher:
    one cooperative launch of as many blocks as the card holds at once, at
    most ``useful``, the count asked once per device and cached."""
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
        [header, f"__global__ void __launch_bounds__({threads}) @K@("]
        + [f"    {p}," for p in params[:-1]] + [f"    {params[-1]}) {{"]
        + body + ["}", ""] + launcher
    )
    name = "stitch_" + hashlib.sha256(text.encode()).hexdigest()[:16]
    return name, text.replace("@K@", name)


# --------------------------------------------------------------------------
# The kernel wrapper and the compiled-kernel record
# --------------------------------------------------------------------------


class KernelProgram:
    """One generated kernel: its CUDA source, its plain version, and the
    launch counter.  Calling it dispatches on the inputs' device: CPU
    tensors go to the plain version, CUDA tensors to the kernel, anything
    else raises.  A call with no inputs runs on ``device``, which defaults
    to the card.  ``launches`` counts kernel launches only.

    ``KernelProgram.launches_by_emitter`` tallies every program's
    ``launches`` by emitter: each change to one moves it by as much.  Set
    to 0 before a run and read after, it gives the run's generated-kernel
    launches, those of programs the run made and dropped included."""

    launches_by_emitter: Dict[str, int] = {"emit_fusion": 0, "emit_stitched_fusion": 0}

    def __init__(self, name: str, source: str, emitter: str, plain: Callable,
                 inputs: Sequence[Instruction], outputs: Sequence[Instruction],
                 workspace_bytes: int, shared_bytes: int = 0):
        self.name = name
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
    per-block workspace region past ``SMEM_LIMIT``), INLINE members composed
    into their consumers, a CUDA block per plan block and independent member
    group, cooperative reduces (module docstring)."""
    _check_no_collectives(fusion)
    name, source, ws, shared = _cuda_fusion(fusion, solution, plan)
    program = KernelProgram(
        name, source, "emit_fusion", _plain_fusion(fusion, solution),
        fusion.inputs, fusion.roots, ws, shared,
    )
    return StitchedKernel(fusion, solution, plan, program, fusion.inputs, fusion.roots)


def emit_stitched_fusion(
    fusion: FusedComputation,
    stitched: StitchedSolution,
    plan: StitchedMemoryPlan,
) -> StitchedKernel:
    """Every phase of a stitched group in ONE cooperative CUDA launch over
    the grid, with the plan's slots in shared memory (module docstring)."""
    _check_no_collectives(fusion)
    name, source, ws, shared = _cuda_stitched(fusion, stitched, plan)
    program = KernelProgram(
        name, source, "emit_stitched_fusion", _plain_stitched(fusion, stitched, plan),
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
