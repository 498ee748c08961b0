"""Lower an ATen graph captured from a PyTorch function into StitchIR — the
counterpart of ``repro/frontend/jaxpr_lower.py``.

``frontend.api.capture`` traces a function with ``make_fx`` (functionalized,
under the core ATen decompositions, on fake tensors) into a
``torch.fx.GraphModule``; ``lower_graph`` walks its nodes and emits the
equivalent StitchIR ``Module`` through the port's ``GraphBuilder``, so the
unchanged pass pipeline compiles ordinary PyTorch programs.

Lowering rules worth knowing (each the reference's, by name):

  * ATen broadcasts *implicitly* (Python-scalar operands, lower-rank and
    size-1 operands); ``to_shape`` materializes that as explicit
    ``broadcast`` instructions, the shape ops a hand-built graph writes.
  * ``mm``/``bmm`` become StitchIR's batched ``dot``.  The decomposition
    of an N-d ``matmul`` (``expand`` + ``view`` to 3-d, ``bmm``, ``view``
    back) folds into one ``dot`` over the original batch dims, so
    ``q @ k.transpose(-1, -2)`` lowers to a transpose and a dot, as the
    reference's ``_dot_general`` lowers it.  ``permute(mm(a, b))`` in 2-d
    commutes to ``mm(b^T, a^T)`` (``_commute_dot_transpose``).
  * tensor constants the capture lifts (a closure's tensors, ``get_attr``
    nodes) and Python scalars fold as IR ``constant``s.
  * dead nodes are dropped (``_live_nodes``), but an unused argument stays
    a parameter; an output that aliases an input or another output gets a
    value-preserving sink (``_finish_outputs``).
  * a nondeterministic or side-effecting op (``rand_like``, ``bernoulli``,
    ``_print``, an in-place op left after functionalization) is kept by
    the liveness pass and raises: it is never dropped.
  * a slice (``slice``, ``select``, each part of ``split_with_sizes``) is
    StitchIR's ``slice``, a view read at an offset index; a write into a
    slice or a row, as functionalization leaves ``t[..., i, :i] = v``
    (``slice_scatter``, ``select_scatter``), the ``concat`` of the value
    with the slices of the base before and after it, and the functional
    ``copy`` beneath it the value cast and broadcast to its target; a constant pad a
    ``concat`` with a broadcast constant; a depthwise 1-D convolution its
    taps, each a slice of the padded input times a broadcast column of the
    weight (``_depthwise_conv1d``); ``cumsum`` StitchIR's ``cumsum``, a
    running sum along one dim.  Each counts ``lower.<op>`` on the tracer.
  * control flow: ``higher_order.scan`` becomes a ``call`` loop (its
    ``additional_inputs`` the loop's constants; a ``flip``-wrapped scan,
    torch's ``reverse=True``, a reversed loop); ``higher_order.while_loop``
    a loop where the canonical counter pattern proves a static trip count;
    ``higher_order.cond`` inlines both branches behind ``select``.
  * collectives (``lower_sharded_graph``, a per-shard body captured at
    local shapes): the ``_c10d_functional`` ops that
    ``torch.distributed._functional_collectives`` leaves in the graph,
    ``all_reduce`` (sum), ``all_gather_into_tensor`` and
    ``reduce_scatter_tensor``, become StitchIR's collectives over the mesh
    axes their process group names; ``wait_tensor`` lowers to nothing.  A
    gather along dim d > 0 is captured as a dim-0 gather, an equal split
    and a ``cat`` along d, and a scatter along d as a split along d and a
    ``cat`` along 0 before a dim-0 scatter: each folds back into one
    collective along d (``_collective_folds``), as the reference lowers
    ``all_gather``/``psum_scatter`` with ``axis=d``.

Anything else raises ``UnsupportedPrimitiveError`` naming the ATen op and
the FX node (``repro_torch.stitch`` turns that into an eager run of the
plain function when ``on_unsupported="fallback"``).
"""
from __future__ import annotations

import math
import operator
from collections import Counter
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import tracing
from ..core.ir import BFLOAT16, GraphBuilder, Module, Tensor, _prod

# --------------------------------------------------------------------------
# Op tables, keyed by ATen overload name (``op_name``)
# --------------------------------------------------------------------------

#: ATen unary op -> StitchIR elementwise fn
UNARY_OPS: Dict[str, str] = {
    "aten.exp.default": "exp",
    "aten.log.default": "log",
    "aten.log1p.default": "log1p",
    "aten.tanh.default": "tanh",
    "aten.sqrt.default": "sqrt",
    "aten.rsqrt.default": "rsqrt",
    "aten.neg.default": "neg",
    "aten.abs.default": "abs",
    "aten.sign.default": "sign",
    "aten.floor.default": "floor",
    "aten.sigmoid.default": "sigmoid",
    "aten.logical_not.default": "not",
    "aten.cos.default": "cos",
    "aten.sin.default": "sin",
    "aten.reciprocal.default": "reciprocal",
}

#: ATen binary op -> StitchIR elementwise fn (``.Scalar`` overloads take a
#: Python number as the second operand)
BINARY_OPS: Dict[str, str] = {
    **{f"aten.{op}.{ov}": fn
       for op, fn in (("add", "add"), ("sub", "sub"), ("mul", "mul"), ("div", "div"))
       for ov in ("Tensor", "Scalar")},
    "aten.maximum.default": "max",
    "aten.minimum.default": "min",
    "aten.pow.Tensor_Tensor": "pow",
    "aten.pow.Scalar": "pow",
    **{f"aten.{op}.{ov}": op
       for op in ("lt", "le", "gt", "ge", "eq", "ne")
       for ov in ("Tensor", "Scalar")},
    "aten.logical_and.default": "and",
    "aten.logical_or.default": "or",
}

#: ATen reduce op -> StitchIR reduce kind
REDUCE_OPS: Dict[str, str] = {
    "aten.sum.default": "sum",
    "aten.sum.dim_IntList": "sum",
    "aten.amax.default": "max",
    "aten.amin.default": "min",
    "aten.mean.default": "mean",
    "aten.mean.dim": "mean",
    "aten.prod.default": "prod",
    "aten.prod.dim_int": "prod",
}

#: value-preserving ops lowered as aliases (no instruction emitted);
#: ``_to_copy`` is one only where it keeps the dtype (else a convert)
IDENTITY_OPS = frozenset(
    {"aten.detach.default", "aten.clone.default", "aten.alias.default",
     "aten._to_copy.default", "aten.lift_fresh_copy.default"}
)

#: structural ops with bespoke lowerings below
STRUCTURAL_OPS = frozenset(
    {"aten.mm.default", "aten.bmm.default", "aten.matmul.default",
     "aten.view.default", "aten._unsafe_view.default", "aten.reshape.default",
     "aten.expand.default", "aten.permute.default", "aten.transpose.int",
     "aten.t.default", "aten.unsqueeze.default", "aten.squeeze.default",
     "aten.squeeze.dim", "aten.squeeze.dims", "aten.cat.default",
     "aten.where.self", "aten._to_copy.default", "aten.to.dtype",
     "aten.pow.Tensor_Scalar", "aten.clamp.default", "aten.flip.default",
     "aten.full.default", "aten.full_like.default", "aten.zeros.default",
     "aten.ones.default", "aten.zeros_like.default", "aten.ones_like.default",
     "aten.scalar_tensor.default", "aten.arange.default", "aten.arange.start",
     "aten.arange.start_step", "prims.iota.default"}
)

#: ops a sequence mixer (a state-space layer, a causal convolution, a
#: chunked delta rule) reads and writes its inputs through, with bespoke
#: lowerings below (``_Lowerer._seq_op``): slices and what is made of them,
#: writes into slices and rows, the depthwise 1-D convolution, the running
#: sum, and the not of a bool mask
SEQUENCE_OPS = frozenset(
    {"aten.slice.Tensor", "aten.select.int", "aten.split_with_sizes.default",
     "aten.constant_pad_nd.default", "aten.convolution.default", "aten.cumsum.default",
     "aten.bitwise_not.default", "aten.slice_scatter.default",
     "aten.select_scatter.default", "aten.copy.default"}
)

#: the functional copies of views that a ``scan`` body's capture leaves,
#: each lowered as its view
VIEW_COPIES: Dict[str, str] = {
    "aten.select_copy.int": "aten.select.int",
    "aten.slice_copy.Tensor": "aten.slice.Tensor",
}

#: control-flow higher-order ops: ``scan`` lowers to a sub-module ``call``
#: loop; ``while_loop`` the same way when a static trip count is provable
#: from the canonical counter pattern; ``cond`` inlines both branches
#: behind ``select``
CONTROL_FLOW_OPS = frozenset(
    {"higher_order.cond", "higher_order.scan", "higher_order.while_loop"}
)

#: cross-rank ops of a per-shard body (``lower_sharded_graph``): the three
#: collectives, and the ``wait_tensor`` that follows each
COLLECTIVE_OPS = frozenset(
    {"_c10d_functional.all_reduce.default",
     "_c10d_functional.all_gather_into_tensor.default",
     "_c10d_functional.reduce_scatter_tensor.default",
     "_c10d_functional.wait_tensor.default"}
)

#: the lowerings the tracer counts, each as ``lower.<op>`` (``VIEW_COPIES``'
#: too, under their own names)
COUNTED_OPS = SEQUENCE_OPS | {"aten.log1p.default"}

SUPPORTED_OPS = frozenset(
    set(UNARY_OPS) | set(BINARY_OPS) | set(REDUCE_OPS)
    | IDENTITY_OPS | STRUCTURAL_OPS | SEQUENCE_OPS | CONTROL_FLOW_OPS | COLLECTIVE_OPS
    | set(VIEW_COPIES)
)

_COMPARE = frozenset({"lt", "le", "gt", "ge", "eq", "ne", "and", "or"})

_NP_DTYPES = {
    torch.float32: np.dtype(np.float32),
    torch.float64: np.dtype(np.float64),
    torch.float16: np.dtype(np.float16),
    torch.bfloat16: BFLOAT16,
    torch.int8: np.dtype(np.int8),
    torch.int16: np.dtype(np.int16),
    torch.int32: np.dtype(np.int32),
    torch.int64: np.dtype(np.int64),
    torch.uint8: np.dtype(np.uint8),
    torch.bool: np.dtype(np.bool_),
}


def np_dtype(dtype: torch.dtype) -> np.dtype:
    """The IR dtype of a torch dtype (``ir.BFLOAT16`` for bfloat16)."""
    try:
        return _NP_DTYPES[dtype]
    except KeyError:
        raise TypeError(f"torch dtype {dtype} has no StitchIR counterpart") from None


def op_name(target) -> str:
    """The table key of an FX node's target: ``aten.exp.default`` for an
    ATen overload, ``higher_order.scan`` for a higher-order op."""
    if isinstance(target, torch._ops.HigherOrderOperator):
        return f"higher_order.{target.name()}"
    if isinstance(target, torch._ops.OpOverload):
        return str(target)
    return getattr(target, "__name__", str(target))


def is_effectful(node) -> bool:
    """Whether a node has an effect its value does not carry: an op that
    mutates its inputs, draws random numbers, or returns nothing (a print).
    Such a node is never dead-code-eliminated: it must reach the lowering
    and raise."""
    t = node.target
    if node.op != "call_function" or not isinstance(t, torch._ops.OpOverload):
        return False
    return (
        t._schema.is_mutable
        or torch.Tag.nondeterministic_seeded in t.tags
        or not t._schema.returns
    )


class UnsupportedPrimitiveError(NotImplementedError):
    """An ATen op the frontend cannot lower to StitchIR.

    Carries the op name (``.primitive``, the reference's attribute) and
    the offending FX node (``.node``), whose stack trace the message
    quotes where the capture recorded one.
    """

    def __init__(self, primitive, node=None, reason: str = ""):
        self.primitive = str(primitive)
        self.node = node
        msg = f"ATen op '{self.primitive}' is not supported by repro_torch.stitch"
        if reason:
            msg += f" ({reason})"
        if node is not None:
            msg += f"\n  in node: {node.format_node()}"
            trace = node.meta.get("stack_trace")
            if trace:
                msg += f"\n  captured at:\n{trace.rstrip()}"
        msg += (
            f"\nsupported ops: {', '.join(sorted(SUPPORTED_OPS))}"
            "\nhint: stitch(fn, on_unsupported='fallback') runs the whole "
            "function eagerly as plain PyTorch instead of failing."
        )
        super().__init__(msg)


@dataclass
class LoweredGraph:
    """A captured function: the StitchIR module plus its calling convention.

    ``param_names`` name the module parameters in flattened-argument order;
    ``output_names`` name one module root per flattened output (outputs that
    alias a parameter/constant or an interior value get a value-preserving
    ``reshape`` sink so the executor materializes them).
    """

    module: Module
    param_names: List[str]
    output_names: List[str]


def _live_nodes(graph) -> set:
    """Reverse-liveness DCE over an FX graph: the nodes the output reads
    transitively, plus every effectful node and what it reads
    (``is_effectful``)."""
    roots = [n for n in graph.nodes if n.op == "output" or is_effectful(n)]
    live: set = set()
    stack = list(roots)
    while stack:
        n = stack.pop()
        if n in live:
            continue
        live.add(n)
        stack.extend(n.all_input_nodes)
    return live


def _flat_outputs(graph) -> list:
    out = next(n for n in graph.nodes if n.op == "output")
    vals = out.args[0]
    return list(vals) if isinstance(vals, (list, tuple)) else [vals]


def _meta(node):
    return node.meta.get("val") if isinstance(node, torch.fx.Node) else None


def _shape(node) -> Tuple[int, ...]:
    return tuple(int(s) for s in _meta(node).shape)


def _dtype(node) -> np.dtype:
    return np_dtype(_meta(node).dtype)


_SPLIT = "aten.split_with_sizes.default"
_CAT = "aten.cat.default"


def _equal_split(node, n: int) -> Optional[int]:
    """The dim along which ``node`` splits its input into ``n`` equal
    parts, each read by exactly one ``getitem`` in order, else None."""
    if op_name(node.target) != _SPLIT:
        return None
    sizes = list(node.args[1])
    if len(sizes) != n or len(set(sizes)) != 1:
        return None
    items = sorted(node.users, key=lambda u: u.args[1] if u.target is operator.getitem else -1)
    if [u.args[1] if u.target is operator.getitem else None for u in items] != list(range(n)):
        return None
    rank = len(_meta(node.args[0]).shape)
    return int(node.args[2] if len(node.args) > 2 else node.kwargs.get("dim", 0)) % rank


def _cat_of_split(cat) -> Optional[Tuple[object, int, int]]:
    """(split node, split dim, cat dim) when ``cat`` concatenates, in
    order, every part of one equal split and nothing else reads them."""
    parts = cat.args[0]
    if not parts or any(p.target is not operator.getitem or len(p.users) != 1 for p in parts):
        return None
    split = parts[0].args[0]
    if any(p.args[0] is not split or p.args[1] != i for i, p in enumerate(parts)):
        return None
    d = _equal_split(split, len(parts))
    if d is None:
        return None
    rank = len(_meta(cat).shape)
    cat_dim = int(cat.args[1] if len(cat.args) > 1 else cat.kwargs.get("dim", 0)) % rank
    return split, d, cat_dim


def _collective_folds(graph) -> Tuple[Dict, set]:
    """The gathers and scatters along a dim > 0, as a capture spells them:
    {node that yields the collective's value: (opcode, source, dim,
    group size, group name)}, and the nodes the fold makes dead."""
    folds: Dict = {}
    dead: set = set()
    for node in graph.nodes:
        if node.op != "call_function" or op_name(node.target) != _CAT:
            continue
        hit = _cat_of_split(node)
        if hit is None:
            continue
        split, d, cat_dim = hit
        parts = list(node.args[0])
        src = split.args[0]
        n = len(parts)
        # gather: wait(all_gather_into_tensor(x, n, g)) split on 0, cat on d
        if d == 0 and cat_dim != 0 and op_name(src.target) == "_c10d_functional.wait_tensor.default" \
                and len(src.users) == 1:
            ag = src.args[0]
            if op_name(ag.target) == "_c10d_functional.all_gather_into_tensor.default" \
                    and len(ag.users) == 1 and int(ag.args[1]) == n:
                folds[node] = ("all_gather", ag.args[0], cat_dim, n, ag.args[2])
                dead.update([ag, src, split, *parts])
                continue
        # scatter: reduce_scatter_tensor(cat on 0 of x split on d)
        if cat_dim == 0 and d != 0 and len(node.users) == 1:
            rs = next(iter(node.users))
            if op_name(rs.target) == "_c10d_functional.reduce_scatter_tensor.default" \
                    and int(rs.args[2]) == n and rs.args[1] == "sum":
                folds[rs] = ("reduce_scatter", src, d, n, rs.args[3])
                dead.update([node, split, *parts])
    return folds, dead


class _Lowerer:
    def __init__(self, builder: GraphBuilder, fuse_dot: bool,
                 group_axes: Optional[Dict[str, Tuple[str, ...]]] = None):
        self.b = builder
        self.fuse_dot = fuse_dot
        #: process group name -> the mesh axes it spans (sharded capture)
        self.group_axes = dict(group_axes or {})
        self._folds: Dict = {}
        #: flip results -> their sources, so a flip of a flip (torch's
        #: reversed scan) cancels
        self._flip_of: Dict[int, Tensor] = {}

    # -- environment ------------------------------------------------------
    def read(self, env: Dict, arg) -> Tensor:
        if isinstance(arg, torch.fx.Node):
            return env[arg]
        raise TypeError(f"expected a tensor operand, got {arg!r}")

    def scalar(self, value, dtype) -> Tensor:
        """A rank-0 IR constant of ``value`` in ``dtype``."""
        if np.dtype(dtype) == BFLOAT16:
            return self.b.constant(np.asarray(value, np.float32), BFLOAT16)
        return self.b.constant(np.asarray(value, dtype=dtype))

    def operand(self, env: Dict, arg, dtype, shape) -> Tensor:
        """A tensor or Python-number operand as ``dtype`` at ``shape``."""
        if isinstance(arg, torch.fx.Node):
            return self.to_shape(self.b.convert(env[arg], dtype), shape)
        return self.to_shape(self.scalar(arg, dtype), shape)

    def to_shape(self, t: Tensor, shape: Sequence[int]) -> Tensor:
        """Materialize ATen implicit broadcasting (scalars, lower rank,
        size-1 dims) as one explicit ``broadcast``."""
        shape = tuple(int(s) for s in shape)
        if tuple(t.shape) == shape:
            return t
        lead = len(shape) - t.ndim
        if lead < 0:
            raise ValueError(f"cannot broadcast rank-{t.ndim} value {tuple(t.shape)} to {shape}")
        return self.broadcast(t, shape, tuple(range(lead, len(shape))))

    def broadcast(self, t: Tensor, shape, dims) -> Tensor:
        """``broadcast`` composed through a broadcast operand, so chains
        (an ``unsqueeze`` then an implicit broadcast) emit one."""
        src = t.instr
        if src.opcode == "broadcast":
            inner = tuple(src.attrs["dims"])
            return self.b.broadcast(
                Tensor(self.b, src.operands[0]), shape, tuple(dims[d] for d in inner)
            )
        return self.b.broadcast(t, shape, dims)

    def reshape(self, t: Tensor, shape) -> Tensor:
        """``reshape``, looking through a reshape operand (a row-major
        reshape of a reshape is one reshape; back to the source's shape it
        is the source)."""
        shape = tuple(int(s) for s in shape)
        if tuple(t.shape) == shape:
            return t
        if t.instr.opcode == "reshape":
            src = Tensor(self.b, t.instr.operands[0])
            return src if tuple(src.shape) == shape else self.b.reshape(src, shape)
        return self.b.reshape(t, shape)

    # -- node dispatch ------------------------------------------------------
    def lower_nodes(self, gm, env: Dict, live: set) -> None:
        # an effect is named before any op that merely lacks a lowering
        for node in gm.graph.nodes:
            if is_effectful(node):
                raise UnsupportedPrimitiveError(
                    op_name(node.target), node, "nondeterministic or side-effecting "
                    "op: it is never dropped, and StitchIR has no effects",
                )
        folds, dead = _collective_folds(gm.graph) if self.group_axes else ({}, set())
        self._folds.update(folds)
        for node in gm.graph.nodes:
            if node.op in ("placeholder", "output") or node not in live or node in dead:
                continue
            if node.op == "get_attr":
                value = getattr(gm, node.target)
                if isinstance(value, torch.Tensor):
                    env[node] = self.const_tensor(value)
                else:
                    env[node] = value     # a sub-graph of a control-flow op
                continue
            if node.target is operator.getitem:
                env[node] = env[node.args[0]][node.args[1]]
                continue
            env[node] = self.lower_node(env, node)

    def const_tensor(self, value: torch.Tensor) -> Tensor:
        value = value.detach().cpu()
        dt = np_dtype(value.dtype)
        if dt == BFLOAT16:
            return self.b.constant(value.to(torch.float32).numpy(), BFLOAT16)
        return self.b.constant(value.numpy().copy())

    def lower_node(self, env: Dict, node):
        name = op_name(node.target)
        if name in VIEW_COPIES:
            tracing.count(f"lower.{name.split('.')[1]}", 1)
            name = VIEW_COPIES[name]
        if name == "higher_order.scan":
            return self._lower_scan(env, node)
        if name == "higher_order.while_loop":
            return self._lower_while(env, node)
        if name == "higher_order.cond":
            return self._lower_cond(env, node)
        if node in self._folds or (name in COLLECTIVE_OPS and self.group_axes):
            return self._collective(env, node, name)
        if node.kwargs.get("alpha", 1) != 1:
            raise UnsupportedPrimitiveError(name, node, "alpha != 1")
        if name in COUNTED_OPS:
            tracing.count(f"lower.{name.split('.')[1]}", 1)
        if name == "aten.split_with_sizes.default":
            return self._split(env, node)
        out_shape, out_dtype = _shape(node), _dtype(node)
        b = self.b
        args = node.args

        if name in IDENTITY_OPS and not (
            name == "aten._to_copy.default" and _dtype(args[0]) != out_dtype
        ):
            return self.read(env, args[0])

        if name in UNARY_OPS:
            fn = UNARY_OPS[name]
            x = self.read(env, args[0])
            x = b.convert(x, np.bool_ if fn == "not" else out_dtype)
            return b.unary(fn, x)

        if name in BINARY_OPS:
            fn = BINARY_OPS[name]
            ct = self._compute_dtype(args[:2]) if fn in _COMPARE else out_dtype
            lhs = self.operand(env, args[0], ct, out_shape)
            rhs = self.operand(env, args[1], ct, out_shape)
            return b.binary(fn, lhs, rhs)

        if name in REDUCE_OPS:
            return self._reduce(env, node, REDUCE_OPS[name], out_dtype)

        if name in ("aten.mm.default", "aten.bmm.default", "aten.matmul.default"):
            return self._dot(env, node)

        if name in ("aten.view.default", "aten._unsafe_view.default", "aten.reshape.default",
                    "aten.squeeze.default", "aten.squeeze.dim", "aten.squeeze.dims"):
            return self.reshape(self.read(env, args[0]), out_shape)

        if name == "aten.unsqueeze.default":
            x = self.read(env, args[0])
            d = int(args[1]) % len(out_shape)
            return self.broadcast(x, out_shape, tuple(i for i in range(len(out_shape)) if i != d))

        if name == "aten.expand.default":
            return self.to_shape(self.read(env, args[0]), out_shape)

        if name in ("aten.permute.default", "aten.transpose.int", "aten.t.default"):
            x = self.read(env, args[0])
            if name == "aten.permute.default":
                perm = tuple(int(p) % max(x.ndim, 1) for p in args[1])
            else:
                perm = list(range(x.ndim))
                d0, d1 = (0, 1) if name == "aten.t.default" else (args[1], args[2])
                d0, d1 = d0 % x.ndim, d1 % x.ndim
                perm[d0], perm[d1] = perm[d1], perm[d0]
                perm = tuple(perm)
            return self._transpose(x, perm)

        if name == "aten.cat.default":
            xs = [b.convert(self.read(env, a), out_dtype) for a in args[0]]
            dim = int(args[1] if len(args) > 1 else node.kwargs.get("dim", 0))
            return b.concat(xs, dim % len(out_shape))

        if name == "aten.where.self":
            pred = self.to_shape(b.convert(self.read(env, args[0]), np.bool_), out_shape)
            on_true = self.operand(env, args[1], out_dtype, out_shape)
            on_false = self.operand(env, args[2], out_dtype, out_shape)
            return b.select(pred, on_true, on_false)

        if name in ("aten._to_copy.default", "aten.to.dtype"):
            return b.convert(self.read(env, args[0]), out_dtype)

        if name == "aten.pow.Tensor_Scalar":
            return self._pow_scalar(env, node, out_dtype)

        if name == "aten.clamp.default":
            x = self.operand(env, args[0], out_dtype, out_shape)
            lo = args[1] if len(args) > 1 else node.kwargs.get("min")
            hi = args[2] if len(args) > 2 else node.kwargs.get("max")
            if lo is not None:
                x = b.binary("max", x, self.operand(env, lo, out_dtype, out_shape))
            if hi is not None:
                x = b.binary("min", x, self.operand(env, hi, out_dtype, out_shape))
            return x

        if name == "aten.flip.default":
            x = self.read(env, args[0])
            for d in args[1]:
                x = self._flip(x, int(d) % x.ndim)
            return x

        if name in ("aten.full.default", "aten.full_like.default", "aten.zeros.default",
                    "aten.ones.default", "aten.zeros_like.default", "aten.ones_like.default",
                    "aten.scalar_tensor.default"):
            # the device kwargs are the capture's, not the plan's: ignored
            if name in ("aten.full.default", "aten.full_like.default"):
                fill = args[1]
            elif name == "aten.scalar_tensor.default":
                fill = args[0]
            else:
                fill = 0 if "zeros" in name else 1
            return self.to_shape(self.scalar(fill, out_dtype), out_shape)

        if name in ("aten.arange.default", "aten.arange.start", "aten.arange.start_step",
                    "prims.iota.default"):
            return self._arange(node, out_shape, out_dtype)

        if name in SEQUENCE_OPS:
            return self._seq_op(env, node, name, out_shape, out_dtype)

        raise UnsupportedPrimitiveError(name, node)

    # -- bespoke lowerings ------------------------------------------------
    def slice(self, x: Tensor, dim: int, start: int, stop: int, step: int = 1) -> Tensor:
        """``x[..., start:stop:step, ...]`` along ``dim``, by Python's rules
        for a positive step; the whole dim is ``x`` itself."""
        start, stop, step = slice(start, stop, step).indices(int(x.shape[dim]))
        if (start, stop, step) == (0, x.shape[dim], 1):
            return x
        starts, limits, strides = [0] * x.ndim, list(x.shape), [1] * x.ndim
        starts[dim], limits[dim], strides[dim] = start, max(start, stop), step
        return self.b.slice(x, starts, limits, strides)

    def _seq_op(self, env: Dict, node, name: str, out_shape, out_dtype):
        b, args = self.b, node.args
        if name == "aten.bitwise_not.default":
            if out_dtype != np.bool_:
                raise UnsupportedPrimitiveError(name, node, "a bitwise not lowers on bool only")
            return b.unary("not", self.read(env, args[0]))
        if name == "aten.cumsum.default":
            if node.kwargs.get("dtype") is not None:
                raise UnsupportedPrimitiveError(name, node, "a dtype argument")
            x = b.convert(self.read(env, args[0]), out_dtype)
            return b.cumsum(x, int(args[1]) % max(x.ndim, 1)) if x.ndim else x
        if name == "aten.convolution.default":
            return self._depthwise_conv1d(env, node, name, out_dtype)
        if name == "aten.copy.default":
            # functional: the target's shape and type, the source's values
            return self.operand(env, args[1], out_dtype, out_shape)
        x = self.read(env, args[0])
        if name in ("aten.slice_scatter.default", "aten.select_scatter.default"):
            return self._scatter(env, node, name, x, out_dtype)
        if name == "aten.constant_pad_nd.default":
            value = args[2] if len(args) > 2 else node.kwargs.get("value", 0)
            return self._pad(x, list(args[1]), value, out_dtype)
        dim = int(args[1] if len(args) > 1 else node.kwargs.get("dim", 0)) % x.ndim
        if name == "aten.select.int":
            i = int(args[2]) % int(x.shape[dim])
            return self.reshape(self.slice(x, dim, i, i + 1), out_shape)
        # aten.slice.Tensor(x, dim, start, end, step): None for a bound is the edge
        start, stop = (args[2] if len(args) > 2 else None), (args[3] if len(args) > 3 else None)
        step = int(args[4] if len(args) > 4 else node.kwargs.get("step", 1))
        return self.slice(x, dim, start, stop, step)

    def _scatter(self, env: Dict, node, name: str, base: Tensor, out_dtype) -> Tensor:
        """``slice_scatter(base, src, dim, start, end, step)`` and
        ``select_scatter(base, src, dim, index)``: ``base`` with ``src``
        written into the slice (a step of 1) or the row, as the ``concat``
        of the slice of ``base`` before it, ``src`` and the slice after."""
        args = node.args
        src = self.b.convert(self.read(env, args[1]), out_dtype)
        dim = int(args[2] if len(args) > 2 else node.kwargs.get("dim", 0)) % base.ndim
        n = int(base.shape[dim])
        if name == "aten.select_scatter.default":
            start = int(args[3]) % n
            stop, step = start + 1, 1
            shape = tuple(base.shape)
            src = self.reshape(src, shape[:dim] + (1,) + shape[dim + 1:])
        else:
            start, stop = (args[3] if len(args) > 3 else None), (args[4] if len(args) > 4 else None)
            start, stop, step = slice(start, stop, int(args[5] if len(args) > 5 else 1)).indices(n)
        if step != 1:
            raise UnsupportedPrimitiveError(name, node, "a write into a slice of step 1 lowers")
        base = self.b.convert(base, out_dtype)
        pieces = [p for p in (self.slice(base, dim, 0, start) if start > 0 else None, src,
                              self.slice(base, dim, stop, n) if stop < n else None)
                  if p is not None]
        return self.b.concat(pieces, dim) if len(pieces) > 1 else src

    def _split(self, env: Dict, node) -> List[Tensor]:
        """``split_with_sizes``: one slice a part, in order."""
        x = self.read(env, node.args[0])
        dim = int(node.args[2] if len(node.args) > 2 else node.kwargs.get("dim", 0)) % x.ndim
        edges = np.cumsum([0] + [int(n) for n in node.args[1]])
        return [self.slice(x, dim, int(lo), int(hi)) for lo, hi in zip(edges[:-1], edges[1:])]

    def _pad(self, x: Tensor, pad: List[int], value, dtype) -> Tensor:
        """``F.pad``'s constant padding: ``pad`` holds (before, after) pairs
        from the last dim back; a positive count concatenates a broadcast
        constant, a negative one slices."""
        for k in range(len(pad) // 2):
            dim = x.ndim - 1 - k
            lo, hi = int(pad[2 * k]), int(pad[2 * k + 1])
            x = self.slice(x, dim, max(0, -lo), int(x.shape[dim]) - max(0, -hi))
            parts = []
            for n in (lo, hi):
                shape = list(x.shape)
                shape[dim] = n
                parts.append(self.to_shape(self.scalar(value, dtype), shape) if n > 0 else None)
            pieces = [p for p in (parts[0], x, parts[1]) if p is not None]
            x = self.b.concat(pieces, dim) if len(pieces) > 1 else x
        return x

    def _depthwise_conv1d(self, env: Dict, node, name: str, out_dtype) -> Tensor:
        """A depthwise 1-D convolution (``groups`` equal to the channels,
        stride and dilation 1, no transposition), as a user's causal
        conv1d writes it: ``out[n, c, t] = bias[c] + sum_k w[c, 0, k] *
        xpad[n, c, t + k]``, with ``xpad`` the input padded with zeros.
        Each tap is a slice of the padded input times a broadcast column of
        the weight, so the planner fuses the taps with what reads them."""
        b = self.b
        x_n, w_n, bias_n, stride, padding, dilation, transposed, _, groups = node.args[:9]
        x, w = (b.convert(self.read(env, a), out_dtype) for a in (x_n, w_n))
        if x.ndim != 3 or transposed or list(stride) != [1] or list(dilation) != [1] \
                or int(groups) != x.shape[1] or tuple(w.shape[:2]) != (x.shape[1], 1):
            raise UnsupportedPrimitiveError(
                name, node, "only a depthwise 1-D convolution lowers: groups equal to the "
                "channels, stride 1, dilation 1, not transposed")
        n, c, _ = (int(s) for s in x.shape)
        taps, p = int(w.shape[2]), int(padding[0])
        x = self._pad(x, [p, p], 0, out_dtype)
        length = int(x.shape[2]) - taps + 1
        out = None
        for k in range(taps):
            col = b.broadcast(self.reshape(self.slice(w, 2, k, k + 1), (c,)), (n, c, length), (1,))
            term = b.binary("mul", self.slice(x, 2, k, k + length), col)
            out = term if out is None else b.binary("add", out, term)
        if bias_n is not None:
            bias = b.convert(self.read(env, bias_n), out_dtype)
            out = b.binary("add", out, b.broadcast(bias, (n, c, length), (1,)))
        return out

    def _axes(self, node, name: str, group: str) -> Tuple[str, ...]:
        if group not in self.group_axes:
            raise UnsupportedPrimitiveError(
                name, node, f"process group {group!r} is no group of the mesh's axes "
                f"(the mesh's groups: {self.group_axes})",
            )
        return self.group_axes[group]

    def _collective(self, env: Dict, node, name: str) -> Tensor:
        b = self.b
        if node in self._folds:
            op, src, dim, n, group = self._folds[node]
            emit = b.all_gather if op == "all_gather" else b.reduce_scatter
            return emit(self.read(env, src), self._axes(node, name, group), dim, n)
        args = node.args
        if name == "_c10d_functional.wait_tensor.default":
            return self.read(env, args[0])
        x = self.read(env, args[0])
        if name == "_c10d_functional.all_gather_into_tensor.default":
            return b.all_gather(x, self._axes(node, name, args[2]), 0, int(args[1]))
        if args[1] != "sum":
            raise UnsupportedPrimitiveError(name, node, f"reduce op {args[1]!r}: only 'sum' lowers")
        if name == "_c10d_functional.all_reduce.default":
            return b.all_reduce(x, self._axes(node, name, args[2]))
        return b.reduce_scatter(x, self._axes(node, name, args[3]), 0, int(args[2]))

    def _compute_dtype(self, args) -> np.dtype:
        """The dtype a comparison computes in: torch's promotion of its
        operands (a Python number takes the tensor's dtype category)."""
        probes = []
        for a in args:
            v = _meta(a)
            probes.append(torch.empty((1,) * v.dim(), dtype=v.dtype, device="meta")
                          if v is not None else a)
        if all(not isinstance(p, torch.Tensor) for p in probes):
            raise TypeError("a comparison of two Python numbers is no graph op")
        return np_dtype(torch.result_type(*probes))

    def _reduce(self, env: Dict, node, kind: str, out_dtype) -> Tensor:
        b = self.b
        x = b.convert(self.read(env, node.args[0]), out_dtype)
        dims = node.args[1] if len(node.args) > 1 else node.kwargs.get("dim")
        keep = bool(node.args[2] if len(node.args) > 2 else node.kwargs.get("keepdim", False))
        if dims is None or (isinstance(dims, (list, tuple)) and len(dims) == 0):
            dims = tuple(range(x.ndim))       # ATen: no dims reduces them all
        elif isinstance(dims, int):
            dims = (dims,)
        dims = tuple(sorted({int(d) % max(x.ndim, 1) for d in dims}))
        if not dims or x.ndim == 0:
            return x
        r = b.reduce(x, dims, kind)
        if keep:
            kept = tuple(i for i in range(x.ndim) if i not in dims)
            r = b.broadcast(r, _shape(node), kept)
        return r

    def _pow_scalar(self, env: Dict, node, out_dtype) -> Tensor:
        """``x ** n`` for an integral ``n`` as XLA lowers ``integer_pow``:
        repeated multiplication (never a transcendental ``pow``, which
        diverges on negative bases); any other exponent is ``pow``."""
        b = self.b
        x = b.convert(self.read(env, node.args[0]), out_dtype)
        e = node.args[1]
        if not float(e).is_integer():
            return b.binary("pow", x, self.to_shape(self.scalar(e, out_dtype), x.shape))
        n = int(e)
        if n == 0:
            return self.to_shape(self.scalar(1, x.dtype), x.shape)
        out = x
        if abs(n) == 2:
            out = b.square(x)
        else:
            for _ in range(abs(n) - 1):
                out = b.binary("mul", out, x)
        if n < 0:
            out = b.unary("reciprocal", out)
        return out

    def _arange(self, node, out_shape, out_dtype) -> Tensor:
        b = self.b
        name = op_name(node.target)
        if name == "prims.iota.default":
            start, step = node.kwargs.get("start", 0), node.kwargs.get("step", 1)
        else:
            a = list(node.args)
            start = a[0] if len(a) > 1 else 0
            step = a[2] if len(a) > 2 else 1
        out = b.iota(out_shape, 0, out_dtype)
        if step != 1:
            out = b.binary("mul", out, self.to_shape(self.scalar(step, out_dtype), out_shape))
        if start != 0:
            out = b.binary("add", out, self.to_shape(self.scalar(start, out_dtype), out_shape))
        return out

    def _transpose(self, x: Tensor, perm: Tuple[int, ...]) -> Tensor:
        if perm == tuple(range(x.ndim)):
            return x
        if perm == (1, 0) and x.instr.opcode == "dot" and not x.instr.users and all(
            o.ndim == 2 for o in x.instr.operands
        ):
            # transpose(dot(a, b)) == dot(b^T, a^T): keeps the dot's result
            # in the default layout; the orphaned dot is swept at the end
            return self._commute_dot_transpose(x.instr)
        return self.b.transpose(x, perm)

    def _commute_dot_transpose(self, dot_instr) -> Tensor:
        """``dot(a, b)^T`` as ``dot(b^T, a^T)``, cancelling an operand that
        is itself a rank-2 transpose instead of stacking a second one."""
        b = self.b

        def flipped(instr) -> Tensor:
            if instr.opcode == "transpose" and tuple(instr.attrs["perm"]) == (1, 0):
                return Tensor(b, instr.operands[0])
            return b.transpose(Tensor(b, instr), (1, 0))

        lhs, rhs = dot_instr.operands
        return b.dot(flipped(rhs), flipped(lhs),
                     fusable=bool(dot_instr.attrs.get("fusable", True)))

    def _unbatched(self, t: Tensor, batch: int) -> Optional[Tensor]:
        """The N-d source of a ``bmm`` operand that ``matmul``'s
        decomposition reshaped to (batch, M, K), or None."""
        instr = t.instr
        if instr.opcode != "reshape":
            return None
        src = Tensor(self.b, instr.operands[0])
        if src.ndim > 3 and tuple(src.shape[-2:]) == tuple(t.shape[-2:]) \
                and _prod(src.shape[:-2]) == batch:
            return src
        return None

    def _dot(self, env: Dict, node) -> Tensor:
        """``mm``/``bmm``/``matmul`` as StitchIR's batched ``dot``: an N-d
        product that the decomposition flattened to ``bmm`` folds back to
        one dot over its original batch dims (the reshape back is then a
        no-op); ``matmul`` itself (uncaptured by the decompositions) lowers
        directly for operands of equal rank >= 2."""
        b = self.b
        lhs = self.read(env, node.args[0])
        rhs = self.read(env, node.args[1])
        out_shape, out_dtype = _shape(node), _dtype(node)
        if lhs.ndim == 3 and rhs.ndim == 3:
            ls, rs = self._unbatched(lhs, lhs.shape[0]), self._unbatched(rhs, rhs.shape[0])
            if ls is not None and rs is not None and ls.shape[:-2] == rs.shape[:-2]:
                lhs, rhs = ls, rs
        if lhs.ndim < 2 or lhs.ndim != rhs.ndim:
            raise UnsupportedPrimitiveError(
                op_name(node.target), node,
                f"product of ranks {lhs.ndim} and {rhs.ndim} (equal ranks >= 2 lower)",
            )
        out = b.dot(b.convert(lhs, out_dtype), b.convert(rhs, out_dtype), fusable=self.fuse_dot)
        return self.reshape(out, out_shape)

    def _flip(self, x: Tensor, dim: int) -> Tensor:
        """Reverse ``x`` along ``dim``: a row ``gather`` by a reversed index
        (dim moved to the front and back), unless ``x`` is itself such a
        flip, which cancels."""
        if dim == 0 and x.instr.id in self._flip_of:
            return self._flip_of[x.instr.id]
        b = self.b
        n = int(x.shape[dim])
        perm = (dim,) + tuple(i for i in range(x.ndim) if i != dim)
        moved = self._transpose(x, perm)
        rows = b.gather(moved, b.constant(np.arange(n - 1, -1, -1, dtype=np.int32)))
        out = self._transpose(rows, tuple(int(i) for i in np.argsort(perm)))
        if dim == 0:
            self._flip_of[out.instr.id] = x
        return out

    # -- control flow ------------------------------------------------------
    def _emit_loop(self, node, body_gm, operands: List[Tensor], order: List[int],
                   names: List[str], *, num_consts: int, num_carry: int, trip_count: int,
                   reverse: bool, kind: str, out_meta) -> List[Tensor]:
        """Shared scan/while tail: lower ``body_gm`` as a sub-module whose
        parameters are its placeholders taken in ``order`` and named
        ``names``, emit one ``call`` loop, and a ``get`` per output.

        The contract with the executor is fully positional (operand order =
        body parameter-creation order; ``out_order`` maps logical output j
        to its position among the body's roots), so two structurally
        identical bodies share one compiled sub-module via
        ``module_signature``."""
        sub = lower_graph(
            body_gm, name=f"{self.b.module.name}.{kind}_body", fuse_dot=self.fuse_dot,
            param_names=names, param_order=order,
        )
        root_pos = {r.name: i for i, r in enumerate(sub.module.roots)}
        out_order = [root_pos[n] for n in sub.output_names]
        call = self.b.call_loop(
            operands, sub.module, trip_count=trip_count, num_consts=num_consts,
            num_carry=num_carry, out_order=out_order,
            out_shapes=[tuple(int(s) for s in v.shape) for v in out_meta],
            out_dtypes=[np_dtype(v.dtype) for v in out_meta],
            reverse=reverse, kind=kind,
        )
        return [self.b.get(call, j) for j in range(len(out_meta))]

    def _lower_scan(self, env: Dict, node) -> List[Tensor]:
        """``higher_order.scan`` -> ``call`` loop.  The body's placeholders
        are (carries, x slices, additional inputs); the loop's operands are
        (constants, carries, xs), so the additional inputs become the
        loop's constants.  An x the body never reads is dropped (a scan
        "without xs" passes a (length, 0) dummy).  Where every x is a
        ``flip`` on dim 0 (torch's ``reverse=True``), the loop runs
        reversed over the unflipped xs and its ys are flipped, which the
        flips torch put after the scan cancel."""
        body_gm, init, xs, extra = node.args[:4]
        body_gm = env[body_gm]
        if len(node.args) > 4 or node.kwargs:
            raise UnsupportedPrimitiveError("higher_order.scan", node, "unknown scan arguments")
        nk, nx, nc = len(init), len(xs), len(extra)
        if nx == 0:
            raise UnsupportedPrimitiveError("higher_order.scan", node, "a scan with no xs has no length")
        trip = int(_meta(xs[0]).shape[0])
        phs = [n for n in body_gm.graph.nodes if n.op == "placeholder"]
        live = _live_nodes(body_gm.graph)
        xs_used = [j for j in range(nx) if phs[nk + j] in live]
        x_vals = [self.read(env, xs[j]) for j in xs_used]
        reverse = bool(x_vals) and all(x.instr.id in self._flip_of for x in x_vals)
        if reverse:
            x_vals = [self._flip_of[x.instr.id] for x in x_vals]
        order = ([nk + nx + i for i in range(nc)] + list(range(nk))
                 + [nk + j for j in xs_used])
        names = ([f"c{i}" for i in range(nc)] + [f"h{i}" for i in range(nk)]
                 + [f"x{i}" for i in range(len(xs_used))])
        operands = [self.read(env, a) for a in extra] + [self.read(env, a) for a in init] + x_vals
        outs = self._emit_loop(
            node, body_gm, operands, order, names, num_consts=nc, num_carry=nk,
            trip_count=trip, reverse=reverse, kind="scan", out_meta=_meta(node),
        )
        if reverse:
            outs = outs[:nk] + [self._flip(y, 0) for y in outs[nk:]]
        return outs

    def _lower_while(self, env: Dict, node) -> List[Tensor]:
        """``higher_order.while_loop`` lowers only when a static trip count
        is provable from the canonical counter pattern: the cond graph is
        one ``lt(carry[i], LIMIT)``, the body sets ``carry[i] + 1``, and
        both the init and LIMIT are constants."""
        cond_gm, body_gm, carried, extra = node.args[:4]
        cond_gm, body_gm = env[cond_gm], env[body_gm]
        carries = [self.read(env, a) for a in carried]
        consts = [self.read(env, a) for a in extra]
        found = self._while_trip_count(cond_gm, body_gm, carries, consts)
        if found is None:
            raise UnsupportedPrimitiveError(
                "while_loop", node,
                "no static trip count: while_loop compiles only when the "
                "condition is the canonical bounded-counter pattern "
                "`carry[i] < LIMIT` with `carry[i] + 1` in the body and "
                "constant init/limit; use scan with a static length",
            )
        nk, nc = len(carries), len(consts)
        order = [nk + i for i in range(nc)] + list(range(nk))
        names = [f"c{i}" for i in range(nc)] + [f"h{i}" for i in range(nk)]
        return self._emit_loop(
            node, body_gm, consts + carries, order, names, num_consts=nc, num_carry=nk,
            trip_count=found, reverse=False, kind="while", out_meta=_meta(node),
        )

    @staticmethod
    def _constant_value(t) -> Optional[float]:
        """The value of a rank-0 (or one-element) IR constant, a Python
        number as itself, else None."""
        if isinstance(t, (int, float)) and not isinstance(t, bool):
            return t
        if isinstance(t, Tensor) and t.instr.opcode == "constant" and t.instr.num_elements == 1:
            return np.asarray(t.instr.attrs["value"]).reshape(()).item()
        return None

    def _while_trip_count(self, cond_gm, body_gm, carries, consts) -> Optional[int]:
        nk = len(carries)
        cphs = [n for n in cond_gm.graph.nodes if n.op == "placeholder"]
        (pred,) = _flat_outputs(cond_gm.graph)
        if not isinstance(pred, torch.fx.Node) or op_name(pred.target) not in (
            "aten.lt.Scalar", "aten.lt.Tensor"
        ):
            return None
        if any(n.op == "call_function" and n is not pred for n in _live_nodes(cond_gm.graph)):
            return None
        ctr, limit = pred.args[:2]
        if ctr not in cphs[:nk]:
            return None
        i = cphs.index(ctr)
        if not np.issubdtype(np.dtype(carries[i].dtype), np.integer):
            return None
        if isinstance(limit, torch.fx.Node):
            if limit in cphs[nk:]:
                limit = self._constant_value(consts[cphs.index(limit) - nk])
            elif limit.op == "get_attr":
                limit = self._constant_value(self.const_tensor(getattr(cond_gm, limit.target)))
            else:
                return None
        limit = self._constant_value(limit)
        init = self._constant_value(carries[i])
        if limit is None or init is None:
            return None
        bphs = [n for n in body_gm.graph.nodes if n.op == "placeholder"]
        step = _flat_outputs(body_gm.graph)[i]
        if not isinstance(step, torch.fx.Node) or op_name(step.target) not in (
            "aten.add.Tensor", "aten.add.Scalar"
        ) or step.kwargs.get("alpha", 1) != 1:
            return None
        x, y = step.args[:2]
        if not ((x is bphs[i] and y == 1) or (y is bphs[i] and x == 1)):
            return None
        return max(0, int(math.ceil(limit - init)))

    def _lower_cond(self, env: Dict, node) -> List[Tensor]:
        """``higher_order.cond`` inlines both branches and selects per
        output (what ``vmap``-of-cond does); the branch payloads fuse into
        the surrounding kernels instead of forcing a host-side branch."""
        pred_arg, true_gm, false_gm, operands = node.args[:4]
        true_gm, false_gm = env[true_gm], env[false_gm]
        b = self.b
        args = [self.read(env, a) for a in operands]
        branch_outs = [self._inline(gm, args) for gm in (true_gm, false_gm)]
        if isinstance(pred_arg, torch.fx.Node):
            pred = b.convert(self.read(env, pred_arg), np.bool_)
        else:
            pred = self.scalar(bool(pred_arg), np.bool_)
        outs = []
        for j, v in enumerate(_meta(node)):
            shape, dtype = tuple(int(s) for s in v.shape), np_dtype(v.dtype)
            on_true, on_false = branch_outs[0][j], branch_outs[1][j]
            for bi, t in ((0, on_true), (1, on_false)):
                if tuple(t.shape) != shape or np.dtype(t.dtype) != dtype:
                    raise UnsupportedPrimitiveError(
                        "higher_order.cond", node,
                        f"branch {bi} output {j} lowered to {np.dtype(t.dtype)}"
                        f"{list(t.shape)} but the cond declares {dtype}{list(shape)}",
                    )
            outs.append(b.select(self.to_shape(pred, shape), on_true, on_false))
        return outs

    def _inline(self, gm, args: List[Tensor]) -> List[Tensor]:
        """Lower a branch graph into this builder with its placeholders
        bound to ``args``; its flattened outputs."""
        phs = [n for n in gm.graph.nodes if n.op == "placeholder"]
        if len(phs) != len(args):
            raise UnsupportedPrimitiveError(
                "higher_order.cond", None,
                f"arity mismatch inlining a branch ({len(args)} args vs {len(phs)} inputs)",
            )
        env: Dict = dict(zip(phs, args, strict=True))
        self.lower_nodes(gm, env, _live_nodes(gm.graph))
        return [self.read(env, o) for o in _flat_outputs(gm.graph)]


@dataclass
class LoweredShardedGraph(LoweredGraph):
    """A per-shard body: the module, captured at local shapes, plus the
    placement its sharded plan runs under.  ``param_layouts`` maps
    parameter names to ``core.shard`` layout tuples; ``out_layouts`` holds
    one layout per module root, in ``module.roots`` order: what
    ``compile_module(..., mesh=, param_layouts=, out_layouts=)`` takes."""

    mesh: object = None
    mesh_axes: Tuple = ()
    param_layouts: Dict[str, Tuple] = None
    out_layouts: List = None


def lower_sharded_graph(
    gm,
    mesh,
    in_layouts: Sequence[Tuple],
    out_layouts: Sequence[Tuple],
    *,
    name: str = "stitched",
    fuse_dot: bool = True,
) -> LoweredShardedGraph:
    """Lower a per-shard body captured at LOCAL shapes (``stitch(mesh=...)``
    does so from the global arguments and ``in_specs``): the counterpart of
    the reference's ``lower_sharded_jaxpr``.  ``in_layouts`` holds one
    layout per placeholder and ``out_layouts`` one per flattened output.
    A collective's process group maps back to mesh axes through
    ``core.comm.group_names(mesh)``; a group that names no axes raises
    ``UnsupportedPrimitiveError``, as does any other collective."""
    from ..core.comm import group_names
    from ..core.shard import mesh_axes_of

    phs = [n for n in gm.graph.nodes if n.op == "placeholder"]
    if len(in_layouts) != len(phs):
        raise ValueError(f"{len(in_layouts)} input layouts for {len(phs)} arguments")
    lowered = lower_graph(gm, name=name, fuse_dot=fuse_dot, group_axes=group_names(mesh))
    if len(out_layouts) != len(lowered.output_names):
        raise ValueError(
            f"{len(out_layouts)} output layouts for {len(lowered.output_names)} outputs"
        )
    by_name = dict(zip(lowered.output_names, out_layouts, strict=True))
    return LoweredShardedGraph(
        lowered.module, lowered.param_names, lowered.output_names,
        mesh=mesh,
        mesh_axes=mesh_axes_of(mesh),
        param_layouts=dict(zip(lowered.param_names, in_layouts, strict=True)),
        out_layouts=[by_name.get(r.name) for r in lowered.module.roots],
    )


def lower_graph(
    gm,
    *,
    name: str = "stitched",
    fuse_dot: bool = True,
    param_names: Optional[Sequence[str]] = None,
    param_order: Optional[Sequence[int]] = None,
    group_axes: Optional[Dict[str, Tuple[str, ...]]] = None,
) -> LoweredGraph:
    """Lower a captured ``torch.fx.GraphModule`` into a StitchIR ``Module``.

    Every placeholder becomes a parameter (the feed contract covers unused
    arguments), created in ``param_order`` (indices into the placeholders;
    default their order) and named by ``param_names`` (one per created
    parameter; default ``arg0..argN``).  ``fuse_dot`` sets the per-dot
    ``fusable`` attr (the paper's user decision — ``StitchOptions.fuse_dot``
    flows through here from ``repro_torch.stitch``).  ``group_axes`` maps
    process group names to mesh axes, and lowers collectives
    (``lower_sharded_graph``); without it a collective raises.
    """
    phs = [n for n in gm.graph.nodes if n.op == "placeholder"]
    order = list(param_order) if param_order is not None else list(range(len(phs)))
    if param_names is None:
        param_names = [f"arg{i}" for i in range(len(order))]
    if len(param_names) != len(order):
        raise ValueError(f"{len(param_names)} param names for {len(order)} parameters")
    b = GraphBuilder(name)
    lw = _Lowerer(b, fuse_dot, group_axes)
    env: Dict = {}
    for pname, k in zip(param_names, order, strict=True):
        v = _meta(phs[k])
        env[phs[k]] = b.parameter(pname, tuple(int(s) for s in v.shape), np_dtype(v.dtype))
    lw.lower_nodes(gm, env, _live_nodes(gm.graph))
    outs = _flat_outputs(gm.graph)
    for o in outs:
        if not isinstance(o, torch.fx.Node):
            raise UnsupportedPrimitiveError(
                "output", None, f"a non-tensor output {o!r}: outputs must be tensors"
            )
    output_names = _finish_outputs(b, [env[o] for o in outs])
    return LoweredGraph(b.module, list(param_names), output_names)


def _finish_outputs(b: GraphBuilder, out_tensors: List[Tensor]) -> List[str]:
    """Shared lowering tail: root sinks for the outputs + orphan sweep.

    Outputs must be module roots (the executor returns sink values).  An
    output that aliases a parameter/constant, an interior value with other
    users, or a repeated output gets a value-preserving reshape sink.

    The sweep removes instructions orphaned by peepholes (folded reshapes,
    composed broadcasts, the commuted dot, cancelled flips) — a user-less
    non-output would otherwise become a phantom module root the executor
    computes and returns on every call.  Parameters stay: the feed contract
    covers unused arguments.
    """
    _sweep(b.module, {t.instr.id for t in out_tensors})
    dup = Counter(t.instr.id for t in out_tensors)
    output_names: List[str] = []
    for t in out_tensors:
        instr = t.instr
        if instr.users or dup[instr.id] > 1 or instr.opcode in ("parameter", "constant"):
            t = b.reshape(t, instr.shape)
            instr = t.instr
        output_names.append(instr.name)
    names = set(output_names)
    _sweep(b.module, {i.id for i in b.module.instructions if i.name in names})
    b.module.verify()
    return output_names


def _sweep(module: Module, keep: set) -> None:
    """Remove every user-less instruction but the parameters and ``keep``
    (instruction ids), until none is left."""
    changed = True
    while changed:
        changed = False
        for instr in list(module.instructions):
            if not instr.users and instr.opcode != "parameter" and instr.id not in keep:
                module.instructions.remove(instr)
                for op in instr.operands:
                    op.users.remove(instr)
                changed = True
