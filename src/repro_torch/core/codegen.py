"""IrEmitterStitched for Hopper — the port of ``repro/core/codegen.py``.

The reference emits one Pallas kernel per fused computation.  Here the two
generators write CUDA C++ instead, and every kernel keeps a plain PyTorch
version beside it:

  * ``emit_fusion`` replaces ``repro/core/codegen.py:emit_fusion`` (its
    ``pl.pallas_call`` at line 234).  One CUDA block runs one grid program
    of the fusion's ``ScheduleSolution``: ``blockIdx.x`` plays the role of
    the Pallas program id ``b``, and the schedule's block-index arithmetic
    (``schedule.block_index``) is printed into the source with the shapes
    baked in as constants.  Chunks divide exactly, so nothing is masked.
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
    cooperative: a warp per output element, shuffles to combine.
    Interface tensors are staged whole in the global workspace —
    StitchPipe's alone is 655,360 bytes, more than one block's 227 KB of
    shared memory — and re-tiled by their consumer phases.

Design of ``emit_fusion`` (right first, fast later): every member's tile is
a dense row-major array in the block's own region of a global workspace
that the wrapper allocates.  Members run in topological order, each as a
strided loop over its tile's elements with ``__syncthreads()`` after it.  A
reduce or a fused dot gives each thread whole output elements and loops
over the reduced extent with f32 accumulation (FMA for dots, no tensor
cores, no TF32); the stitched kernel keeps that for dots.  Scalar constants
are printed as exact hex-float literals.  These kernels read and write
every member tile through global memory (L2 at these sizes), so what bounds
them on the card is launch latency and memory traffic, not arithmetic.

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
from .ir import Instruction, apply_op, broadcast_in_dim, iota, torch_dtype
from .memory import ALLOC, SHARE, MemoryPlan, StitchedMemoryPlan
from .schedule import (
    REPLICATED,
    Sched,
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

FUSION_THREADS = 256      # threads per block of a single-phase kernel
#: threads per block of a stitched kernel (``stitched_threads``)
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

_C_TYPES = {
    np.dtype(np.float32): "float",
    np.dtype(np.float64): "double",
    np.dtype(np.int32): "int",
    np.dtype(np.int64): "long long",
    np.dtype(np.bool_): "bool",
}

_INFIX = {
    "add": "+", "sub": "-", "mul": "*", "div": "/",
    "lt": "<", "le": "<=", "gt": ">", "ge": ">=", "eq": "==", "ne": "!=",
    "and": "&&", "or": "||",
}


def _c_type(dtype) -> str:
    try:
        return _C_TYPES[np.dtype(dtype)]
    except KeyError:
        raise NotImplementedError(
            f"the CUDA emitters take {sorted(str(d) for d in _C_TYPES)}, "
            f"not {np.dtype(dtype)}"
        ) from None


def _c_literal(value, dtype) -> str:
    """An exact C++ literal of one scalar: hex floats carry every bit."""
    dt = np.dtype(dtype)
    v = np.asarray(value, dtype=dt).reshape(())
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
    needs is ``ptr[sum((offs[k] + idx[k]) * strides[k])]``, or a literal."""

    shape: Tuple[int, ...]
    ptr: str = ""
    strides: Tuple[int, ...] = ()
    offs: Tuple = ()
    literal: str = ""

    def at(self, idx) -> str:
        if self.literal:
            return self.literal
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
# combine of two partial results (stitch_runtime.cuh)
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
    return the C expression of its value (the reference's ``_emit_instr``
    and ``apply_op``, per element).  ``lin`` is the linear index of ``idx``
    in the tile, and ``sfx`` keeps the names of the statements' variables
    apart where several values are composed into one expression."""
    op, a = m.opcode, m.attrs
    T = _c_type(m.dtype)
    out_chunk = chunk_shape(m.shape, sched)
    if op == "constant":
        return _c_literal(a["value"], m.dtype)
    if op == "elementwise":
        fn = a["fn"]
        x = ovs[0].at(idx)
        if fn == "convert":
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
    if op == "reduce":
        src = ovs[0]
        rdims = tuple(a["dims"])
        kept = [k for k in range(len(src.shape)) if k not in rdims]
        extent = [src.shape[k] for k in rdims]
        kind = a["kind"]
        lines.append(f"{ind}{T} acc = {_REDUCE_INIT[kind].format(T=T)};")
        lines.append(f"{ind}for (int r = 0; r < {_prod(extent)}; ++r) {{")
        j: List = [0] * len(src.shape)
        for kk, k in enumerate(kept):
            j[k] = idx[kk]
        for k, q in zip(rdims, _unravel(lines, "r", extent, "q", ind + "  "), strict=True):
            j[k] = q
        lines.append(f"{ind}  {_REDUCE_STEP[kind].format(x=src.at(j))}")
        lines.append(f"{ind}}}")
        if kind == "mean":
            return f"(acc / static_cast<{T}>({_prod(extent)}))"
        return "acc"
    if op == "dot":
        lhs, rhs = ovs
        lines.append(f"{ind}{T} acc = static_cast<{T}>(0);")
        lines.append(
            f"{ind}for (int k = 0; k < {lhs.shape[-1]}; ++k) "
            f"acc = sx_fma({lhs.at(list(idx[:-1]) + ['k'])}, "
            f"{rhs.at(list(idx[:-2]) + ['k', idx[-1]])}, acc);"
        )
        return "acc"
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
        expr = piece(len(ovs) - 1)
        for k in range(len(ovs) - 2, -1, -1):
            expr = f"({idx[d]} < {edges[k + 1]} ? {piece(k)} : {expr})"
        return expr
    if op == "gather":
        table, ind_view = ovs
        r = len(ind_view.shape)
        n = m.operands[0].shape[0]
        # jnp.take's default "fill" mode: [-n, n) wraps, the rest fills
        g, ok = f"g{sfx}", f"ok{sfx}"
        lines.append(f"{ind}long long {g} = static_cast<long long>({ind_view.at(idx[:r])});")
        lines.append(f"{ind}const bool {ok} = {g} >= -{n}LL && {g} < {n}LL;")
        lines.append(f"{ind}if ({g} < 0) {g} += {n}LL;")
        return f"({ok} ? {table.at([g] + list(idx[r:]))} : sx_fill<{T}>())"
    raise NotImplementedError(f"{m.name}: no CUDA emission for opcode {op!r}")


def _member_loop(m: Instruction, sched: Sched, ovs: List[_View], b,
                 tile: Optional[str], stores: List[Tuple[str, Tuple[int, ...]]],
                 label: Dict[int, str], ind: str) -> List[str]:
    """One member: a strided loop over its tile, writing the tile and any
    full-shape destinations (fusion outputs, staged interfaces).  Comments
    name values by ``label`` (ordinals, never ids), so structurally equal
    fusions generate equal text and share one built library."""
    out_chunk = chunk_shape(m.shape, sched)
    what = m.opcode + (f":{m.attrs['fn']}" if "fn" in m.attrs else "")
    ops = ", ".join(label[o.id] for o in m.operands)
    lines = [f"{ind}// {label[m.id]} = {what}({ops}) on tile {list(out_chunk)}"]
    lines.append(f"{ind}for (int i = threadIdx.x; i < {_prod(out_chunk)}; i += blockDim.x) {{")
    body = ind + "  "
    idx = _unravel(lines, "i", out_chunk, "o", body)
    expr = _value(m, sched, ovs, idx, b, lines, body)
    lines.append(f"{body}const {_c_type(m.dtype)} v = {expr};")
    if tile is not None:
        lines.append(f"{body}{tile}[i] = v;")
    offs = _c_starts(m.shape, sched, b)
    for ptr, full in stores:
        dst = _View(out_chunk, ptr, _dense_strides(full), offs)
        lines.append(f"{body}{dst.at(idx)} = v;")
    lines.append(f"{ind}}}")
    lines.append(f"{ind}__syncthreads();")
    return lines


def _tile_view(name: str, shape, stored: Sched, needed: Sched, opnd: Instruction, b,
               full: bool) -> _View:
    """The reference's ``_adapt`` as a view: ``full`` arrays (kernel inputs,
    staged interfaces) hold the whole tensor; tiles hold the stored chunk."""
    if stored == needed:
        if full and stored.kind == "chunked":
            return _View(chunk_shape(opnd.shape, stored), name, _dense_strides(opnd.shape),
                         _c_starts(opnd.shape, stored, b))
        return _View(tuple(shape), name, _dense_strides(shape), (0,) * len(shape))
    if stored.kind == "replicated" and needed.kind == "chunked":
        return _View(chunk_shape(opnd.shape, needed), name, _dense_strides(opnd.shape),
                     _c_starts(opnd.shape, needed, b))
    raise ValueError(f"cannot adapt {opnd.name}: stored {stored}, needed {needed}")


def _literal_view(m: Instruction, needed: Sched) -> _View:
    return _View(chunk_shape(m.shape, needed), literal=_c_literal(m.attrs["value"], m.dtype))


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
                   threads: int) -> Tuple[str, str]:
    """Name the kernel by the hash of its text and add its launcher."""
    params, lparams, casts = _signature_c(inputs, roots)
    text = "\n".join(
        [header, f"__global__ void __launch_bounds__({threads}) @K@("]
        + [f"    {p}," for p in params[:-1]] + [f"    {params[-1]}) {{"]
        + body + ["}", ""]
        + ['extern "C" int @K@_launch(']
        + [f"    {p}," for p in lparams] + ["    void* stream) {"]
        + [f"  @K@<<<{grid}, {threads}, 0, static_cast<cudaStream_t>(stream)>>>("]
        + [f"      {c}," for c in casts[:-1]] + [f"      {casts[-1]});"]
        + ["  return static_cast<int>(cudaGetLastError());", "}", ""]
    )
    name = "stitch_" + hashlib.sha256(text.encode()).hexdigest()[:16]
    return name, text.replace("@K@", name)


def _cuda_fusion(fusion: FusedComputation, solution: ScheduleSolution):
    members, inputs, roots = fusion.members, fusion.inputs, fusion.roots
    assign = solution.assignment
    blocks = solution.blocks
    b = _Sym("b") if blocks > 1 else 0
    in_name = {i.id: f"in{k}" for k, i in enumerate(inputs)}
    label = {**in_name, **{m.id: f"m{k}" for k, m in enumerate(members)}}
    out_of = {r.id: (f"out{k}", tuple(r.shape)) for k, r in enumerate(roots)}
    ws = _Workspace()
    tiles: Dict[int, str] = {}
    for k, m in enumerate(members):
        if m.opcode != "constant":
            tiles[m.id] = ws.alloc(f"t{k}", m, chunk_shape(m.shape, assign[m.id]), "wsb", "  ")
    body = ["  const int b = blockIdx.x;"] if blocks > 1 else []
    body.append(f"  unsigned char* const wsb = ws + static_cast<size_t>(blockIdx.x) * {ws.size};")
    body += ws.decls
    const_ids = {m.id: m for m in members if m.opcode == "constant"}
    for m in members:
        sched = REPLICATED if m.id in const_ids else assign[m.id]
        ovs = []
        for o, ns in zip(m.operands, propagate(m, sched), strict=False):
            if o.id in const_ids:
                ovs.append(_literal_view(o, ns))
            elif o.id in tiles:
                ovs.append(_tile_view(tiles[o.id], chunk_shape(o.shape, assign[o.id]),
                                      assign[o.id], ns, o, b, full=False))
            else:
                ovs.append(_tile_view(in_name[o.id], o.shape, assign.get(o.id, REPLICATED),
                                      ns, o, b, full=True))
        stores = [out_of[m.id]] if m.id in out_of else []
        if m.id in const_ids and not stores:
            continue  # read through its literal
        body += _member_loop(m, sched, ovs, b, tiles.get(m.id), stores, label, "  ")
    header = (
        f"// emit_fusion: {len(members)} members, grid {blocks} "
        f"(one block per schedule program), {ws.size} workspace bytes per block"
    )
    name, text = _finish_source(header, body, inputs, roots, blocks, FUSION_THREADS)
    return name, text, ws.size * blocks


def _slot_layout(pplan: MemoryPlan) -> Tuple[List[int], int]:
    """Byte offsets of a phase plan's slots, each 16-byte aligned, and
    their total: the shared memory (or per-block workspace region) the
    phase's ALLOC/SHARE members live in."""
    offs, size = [], 0
    for shape, dtype in pplan.slots:
        offs.append(size)
        size += -(-_prod(shape) * np.dtype(dtype).itemsize // _ALIGN) * _ALIGN
    return offs, size


def stitched_threads(plan: StitchedMemoryPlan) -> int:
    """Threads of each block of a stitched kernel.  A plan block with slots
    runs on one CUDA block, so its threads are all the parallelism that
    plan block gets: the fewest, from 128 up to 512, that leave its
    largest slot at most ``STITCHED_ELEMS_PER_THREAD`` elements a thread.
    512 is the cap because ``__launch_bounds__(512)`` still leaves 128
    registers a thread for the composed expressions."""
    largest = max((_prod(shape) for pp in plan.phase_plans for shape, _ in pp.slots), default=0)
    t = STITCHED_MIN_THREADS
    while t < STITCHED_MAX_THREADS and t * STITCHED_ELEMS_PER_THREAD < largest:
        t *= 2
    return t


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

    def __init__(self, phase: "_StitchedPhase", m: Instruction, stored: Sched, needed: Sched, b):
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


class _StitchedPhase:
    """The CUDA text of one phase of a stitched kernel."""

    def __init__(self, pk: int, phase, pplan: MemoryPlan, threads: int, in_name, staged, out_of,
                 label, slot_base: Optional[str]):
        self.pk, self.phase, self.pplan, self.threads = pk, phase, pplan, threads
        self.assign = phase.solution.assignment
        self.blocks = phase.solution.blocks
        self.b = _Sym("b") if self.blocks > 1 else 0
        self.in_name, self.staged, self.out_of, self.label = in_name, staged, out_of, label
        self.ids = {m.id for m in phase.members}
        self.const_ids = {m.id for m in phase.members if m.opcode == "constant"}
        self.offs, self.slot_bytes = _slot_layout(pplan)
        self.slot_base = slot_base            # None: a pure map, no slot
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
        ovs = [self.view(o, ns) for o, ns in zip(m.operands, propagate(m, sched), strict=False)]
        before = len(self.lines)
        expr = _value(m, sched, ovs, idx, self.b, self.lines, self.ind, lin=lin, sfx=sfx)
        if m.opcode == "concat" and len(self.lines) > before:
            raise NotImplementedError(
                f"{m.name}: a concat of composed values that need statements "
                "would run them for the pieces it does not take"
            )
        return expr

    # ---- the loops ---------------------------------------------------------
    def _stores(self, m: Instruction, sched: Sched, idx, v: str) -> List[str]:
        """The fusion outputs and staged interfaces ``m`` writes."""
        dests = [self.out_of[m.id]] if m.id in self.out_of else []
        if m.id in self.staged:
            dests.append((self.staged[m.id], tuple(m.shape)))
        offs = _c_starts(m.shape, sched, self.b)
        out_chunk = chunk_shape(m.shape, sched)
        return [f"{_View(out_chunk, p, _dense_strides(full), offs).at(idx)} = {v};"
                for p, full in dests]

    def _tile_write(self, m: Instruction, out_chunk, idx) -> Optional[str]:
        if m.id not in self.tiles:
            return None
        return _View(out_chunk, self.tiles[m.id], _dense_strides(out_chunk), (0,) * len(out_chunk)).at(idx)

    def _check_own_slot(self, m: Instruction, write: Optional[str], text: str) -> None:
        """A SHARE member may read its slot's previous owner (through the
        values composed into it) only at the element the same thread then
        writes; anywhere else another thread could have overwritten it."""
        if write is None:
            return
        ptr = self.tiles[m.id]
        mine = _indices(write, ptr)
        if any(i != mine[0] for i in _indices(text, ptr)):
            raise NotImplementedError(
                f"{m.name}: reads its own slot {ptr} at another element than it writes"
            )

    def _element_body(self, m: Instruction, sched: Sched, out_chunk, ind: str):
        """Statements and value expression of element ``i`` of ``m``'s tile."""
        self.lines, self.ind = [], ind
        idx = _unravel(self.lines, "i", out_chunk, "o", ind)
        T = _c_type(m.dtype)
        if m.opcode == "dot":
            lhs, rhs = [self.view(o, ns) for o, ns in zip(m.operands, propagate(m, sched), strict=False)]
            self.lines.append(f"{ind}{T} acc = static_cast<{T}>(0);")
            self.lines.append(f"{ind}for (int k = 0; k < {lhs.shape[-1]}; ++k) {{")
            self.ind = ind + "  "
            a = lhs.at(list(idx[:-1]) + ["k"])
            c = rhs.at(list(idx[:-2]) + ["k", idx[-1]])
            self.lines.append(f"{ind}  acc = sx_fma({a}, {c}, acc);")
            self.lines.append(f"{ind}}}")
            self.ind = ind
            expr = "acc"
        else:
            expr = self.value(m, sched, idx, "i", "")
        return idx, self.lines, expr

    def element_loop(self, m: Instruction, ind: str) -> List[str]:
        sched = self.sched(m)
        out_chunk = chunk_shape(m.shape, sched)
        n, T, th = _prod(out_chunk), _c_type(m.dtype), self.threads
        body = ind + "  "
        pure = self.slot_base is None
        reps = self.blocks if pure and sched.kind == "chunked" else 1
        lines = []
        if pure:
            # a pure map: the elements of every plan block stride over the grid
            total = n * reps
            lines.append(f"{ind}for (int t = blockIdx.x * {th} + threadIdx.x; t < {total}; "
                         f"t += gridDim.x * {th}) {{")
            if reps > 1:
                lines.append(f"{body}const int b = t / {n};")
                lines.append(f"{body}const int i = t % {n};")
            else:
                lines.append(f"{body}const int i = t;")
            self.useful_blocks = max(self.useful_blocks, -(-total // th))
        idx, stmts, expr = self._element_body(m, sched, out_chunk, body)
        write = self._tile_write(m, out_chunk, idx)
        self._check_own_slot(m, write, "\n".join(stmts) + expr)
        if not pure:
            lines += _counted_loop("i", "threadIdx.x", th, n, ind)
        lines += stmts
        lines.append(f"{body}const {T} v = {expr};")
        if write is not None:
            lines.append(f"{body}{write} = v;")
        lines += [body + s for s in self._stores(m, sched, idx, "v")]
        lines.append(f"{ind}}}")
        return lines

    def reduce_loop(self, m: Instruction, ind: str) -> List[str]:
        """A cooperative reduce: a warp per output element, its lanes
        striding over the reduced elements, then a butterfly of shuffles."""
        sched = self.sched(m)
        out_chunk = chunk_shape(m.shape, sched)
        r_out, T, th = _prod(out_chunk), _c_type(m.dtype), self.threads
        warps = th // 32
        (src,) = [self.view(o, ns) for o, ns in zip(m.operands, propagate(m, sched), strict=False)]
        rdims = tuple(m.attrs["dims"])
        kind = m.attrs["kind"]
        kept = [k for k in range(len(src.shape)) if k not in rdims]
        extent = [src.shape[k] for k in rdims]
        pure = self.slot_base is None
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
        write = self._tile_write(m, out_chunk, idx)
        stmts = self.lines
        self._check_own_slot(m, write, "\n".join(stmts))
        if not pure:
            lines.append(f"{ind}for (int o = threadIdx.x >> 5; o < {r_out}; o += {warps}) {{")
        lines += stmts
        lines.append(f"{body}if ((threadIdx.x & 31) == 0) {{")
        lines.append(f"{body}  const {T} v = {v};")
        if write is not None:
            lines.append(f"{body}  {write} = v;")
        lines += [body + "  " + s for s in self._stores(m, sched, idx, "v")]
        lines += [f"{body}}}", f"{ind}}}"]
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
                out += self.reduce_loop(m, "  ") if m.opcode == "reduce" else self.element_loop(m, "  ")
            return out
        where = "shared memory" if self.slot_base == "sx_smem" else "a per-block workspace region"
        out = [f"  // phase {pk}: {len(ph.members)} members, {self.blocks} plan blocks over the grid, "
               f"slots {self.slot_bytes} bytes in {where}",
               "  {"]
        for slot, ptr in sorted(self.slot_ptr.items()):
            T = _c_type(self.pplan.slots[slot][1])
            out.append(f"    {T}* const {ptr} = reinterpret_cast<{T}*>({self.slot_base} + {self.offs[slot]});")
        out.append(f"    for (int b = blockIdx.x; b < {self.blocks}; b += gridDim.x) {{")
        for m in stored:
            out.append(self._comment(m, "      "))
            out += self.reduce_loop(m, "      ") if m.opcode == "reduce" else self.element_loop(m, "      ")
            out.append("      __syncthreads();")
        out += ["    }", "  }"]
        self.useful_blocks = max(self.useful_blocks, self.blocks)
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
    grid = 1
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
        ph = _StitchedPhase(pk, phase, pplan, threads, in_name, staged, out_of, label, base)
        body += ph.emit()
        grid = max(grid, ph.useful_blocks)
    header = (
        f"// emit_stitched_fusion: {stitched.num_phases} phases, {stitched.blocks} plan blocks "
        f"in all, one cooperative launch of up to {grid} blocks of {threads} threads, "
        f"{smem} bytes of shared memory a block, {ws.size + region} workspace bytes"
    )
    name, text = _finish_cooperative(header, body, inputs, roots, grid, threads, smem)
    return name, text, ws.size + region


def _finish_cooperative(header: str, body: List[str], inputs, roots, useful: int,
                        threads: int, smem: int) -> Tuple[str, str]:
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
    if smem > STATIC_SMEM_LIMIT:
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
    to the card.  ``launches`` counts kernel launches only."""

    def __init__(self, name: str, source: str, emitter: str, plain: Callable,
                 inputs: Sequence[Instruction], outputs: Sequence[Instruction],
                 workspace_bytes: int):
        self.name = name
        self.source = source
        self.emitter = emitter
        self.plain = plain
        self.in_specs = [(tuple(i.shape), torch_dtype(i.dtype)) for i in inputs]
        self.out_specs = [(tuple(r.shape), torch_dtype(r.dtype)) for r in outputs]
        self.workspace_bytes = workspace_bytes
        self.launches = 0
        self._launch = None

    def load(self, lib: ctypes.CDLL) -> None:
        """Bind this kernel's launcher in a built library."""
        fn = getattr(lib, self.name + "_launch")
        fn.argtypes = [ctypes.c_void_p] * (len(self.in_specs) + len(self.out_specs) + 2)
        fn.restype = ctypes.c_int
        self._launch = fn

    def __call__(self, *args, device=None):
        dev = input_device(self.name, args) if args else resolve_device(device)
        if dev.type == "cpu":
            return self.plain(*args, device=dev)
        return self.launch(*args, device=dev)

    def launch(self, *args, device) -> Tuple[torch.Tensor, ...]:
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
        outs = [torch.empty(s, dtype=d, device=device) for s, d in self.out_specs]
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

    def __call__(self, *args, device=None):
        return self.fn(*args, device=device)

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
    """One schedule-consistent fusion as a CUDA kernel of ``solution.blocks``
    blocks.  ``plan`` is the reference's scratch plan: ALLOC/SHARE members
    round-trip through scratch there, which changes no value, and here every
    member keeps a workspace tile."""
    _check_no_collectives(fusion)
    name, source, ws = _cuda_fusion(fusion, solution)
    program = KernelProgram(
        name, source, "emit_fusion", _plain_fusion(fusion, solution),
        fusion.inputs, fusion.roots, ws,
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
    name, source, ws = _cuda_stitched(fusion, stitched, plan)
    program = KernelProgram(
        name, source, "emit_stitched_fusion", _plain_stitched(fusion, stitched, plan),
        fusion.inputs, fusion.roots, ws,
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
