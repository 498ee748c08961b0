"""Exact static cost analysis by counting the ATen ops of a function as they
dispatch — the reference's ``repro/launch/costmodel.py`` in torch.

The reference walks a jaxpr, multiplying each scan body by its length.
The port's loops (the layers, the attention chunks, the CE chunks,
gradient accumulation) are Python loops, so every trip dispatches its ops
again: counting ops as they run (a ``TorchDispatchMode``) counts a loop
once per trip, the backward's ops and ``torch.utils.checkpoint``'s
recompute as they run.  On ``meta`` tensors nothing is computed or
allocated; a function that reads a tensor's value on the host cannot be
counted there.

Conventions (the reference's, op for op):
  * products (``mm``, ``bmm``, ``addmm``, ``baddbmm``, ``convolution``):
    2·prod(out)·prod(contract) FLOPs; bytes = operands + out (an
    ``addmm``/``baddbmm`` also charges its bias add as an elementwise op);
  * elementwise (the reference's ``_EW``, the ``*_backward`` pointwise ops,
    converts and copies): 1 FLOP per output element; bytes = output only
    (consumers fuse — a deliberate *approximation*);
  * reduces (sums, maxima, softmaxes, norms, cumulative ops): 1 FLOP per
    input element; bytes = in + out;
  * gathers (``index_select``, ``gather``, ``embedding``, ``index``): 2 ×
    out bytes; scatters (``scatter*``, ``index_put``, ``index_add``,
    ``*_scatter``): 2 × the update's bytes; ``cat``, ``sort``, ``topk``: in +
    out, the last two n·log2(n) FLOPs;
  * movement that makes a new tensor (copies of slices, pads, fills,
    iota, collectives): bytes = output;
  * a view (an output in an input's storage) and a bare allocation
    (``empty``) move nothing and are charged nothing, where the reference
    charges each reshape, transpose and broadcast its output: on the ten
    reduced forwards the port's ``bytes`` read 0.73-0.92 of the
    reference's (``tests/test_torch_launch.py``);
  * an ``einsum``'s product with no contracted dim, which torch runs as an
    elementwise ``mul``, is a product, 2·prod(out) FLOPs, as the
    reference's ``dot_general`` with an empty contraction;
  * a converted tensor read by a product is charged at its SOURCE dtype
    (the reference's ``src_bytes``: int8 caches and bf16 params at their
    real bandwidth), through any view of it.
``bytes`` is the unfused upper bound; ``bytes_min`` charges only
kernel-boundary ops (products, reduces, gathers, scatters, sorts, cats).
Numbers are GLOBAL logical costs when the function runs on global shapes.

The mode also keeps what ``launch/hlostats.py`` and the dry run read: the
op tally (calls by op), every collective with its result bytes, and the
peak of live bytes of the storages the function makes (each output's
storage tracked until it dies; an estimate of XLA's ``temp_size``).
"""
from __future__ import annotations

import collections
import math
import weakref
from typing import Any, Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

_ZERO = {"flops": 0.0, "bytes": 0.0, "bytes_min": 0.0, "dot_flops": 0.0}

_DOT = {"mm", "bmm", "addmm", "baddbmm", "convolution", "_convolution", "addbmm"}
_EW = {
    "add", "sub", "rsub", "mul", "div", "maximum", "minimum", "pow", "exp", "exp2",
    "log", "log2", "tanh", "sigmoid", "erf", "erfinv", "rsqrt", "sqrt", "neg", "abs",
    "sign", "floor", "ceil", "round", "trunc", "ne", "eq", "ge", "gt", "le", "lt",
    "logical_and", "logical_or", "logical_not", "logical_xor", "bitwise_and",
    "bitwise_or", "bitwise_not", "bitwise_xor", "clamp", "clamp_min", "clamp_max",
    "remainder", "fmod", "atan2", "cos", "sin", "expm1", "log1p", "square",
    "reciprocal", "where", "masked_fill", "_to_copy", "copy", "clone", "isfinite",
    "isnan", "isinf", "silu", "gelu", "relu", "softplus", "lerp", "addcmul",
    "addcdiv", "nan_to_num", "bitwise_left_shift", "bitwise_right_shift",
    "convert_element_type", "fill", "zero", "hardtanh", "leaky_relu", "elu",
}
_REDUCE = {
    "sum", "mean", "amax", "amin", "max", "min", "prod", "argmax", "argmin", "any",
    "all", "cumsum", "cumprod", "logsumexp", "var", "std", "var_mean", "norm",
    "linalg_vector_norm", "_softmax", "_log_softmax", "_softmax_backward_data",
    "_log_softmax_backward_data", "native_layer_norm", "native_layer_norm_backward",
    "_fused_rms_norm", "_fused_rms_norm_backward", "nll_loss_forward",
    "nll_loss_backward", "logcumsumexp", "cummax", "cummin",
}
_GATHER = {"index_select", "gather", "embedding", "index", "take"}
_SCATTER = {"scatter", "scatter_add", "scatter_reduce", "index_put", "index_add",
            "index_copy", "slice_scatter", "select_scatter", "masked_scatter",
            "embedding_dense_backward", "index_fill", "_index_put_impl"}
_SORT = {"sort", "topk"}
_CONCAT = {"cat", "stack"}
#: no work at all: aliases and the functional collectives' wait
_FREE = {"detach", "alias", "lift_fresh", "wait_tensor", "_local_scalar_dense", "lift",
         "_has_compatible_shallow_copy_type", "set_", "record_stream", "resize_"}

#: ops that only allocate: nothing is read or written
_ALLOC = {"empty", "empty_like", "new_empty", "empty_strided", "new_empty_strided"}


def _is_mutating(func) -> bool:
    return bool(getattr(func, "_schema", None) is not None and func._schema.is_mutable)


#: collective op (by name, any namespace) -> the reference's census kind
COLLECTIVE_KINDS = {
    "all_reduce": "all-reduce", "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather", "allgather_": "all-gather",
    "_allgather_base_": "all-gather", "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather", "allgather_coalesced_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter", "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter", "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
}


_NAMES: Dict[Any, str] = {}


def op_name(func) -> str:
    """An op's name without namespace and overload (``aten.mm.default`` ->
    ``mm``; an in-place ``add_`` -> ``add``); a collective keeps its own."""
    name = _NAMES.get(func)
    if name is None:
        name = func.overloadpacket.__name__ if hasattr(func, "overloadpacket") else str(func)
        if name not in COLLECTIVE_KINDS and name.endswith("_") and not name.startswith("_"):
            name = name[:-1]
        _NAMES[func] = name
    return name


def _tensors(x) -> List[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _tensors(v)]
    return []


def nbytes(t: torch.Tensor) -> int:
    return int(t.numel()) * t.element_size()


def _key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _operands(name, args):
    """The two matrix operands of a product op."""
    if name in ("addmm", "baddbmm", "addbmm"):
        return args[1], args[2]
    return args[0], args[1]


def op_cost(name: str, args, out, ratio=lambda t: 1.0) -> Dict[str, float]:
    """One op's cost by the conventions of the module docstring (the op
    table).  ``ratio(t)`` is the source-dtype factor of a converted tensor
    (1 elsewhere)."""
    ins = _tensors(args)
    outs = _tensors(out)
    out_elems = sum(int(t.numel()) for t in outs)
    out_bytes = sum(nbytes(t) for t in outs)
    in_bytes = sum(nbytes(t) for t in ins)
    c = dict(_ZERO)
    if name in _FREE:
        return c
    if name in _DOT:
        a, b = _operands(name, args)
        k = math.prod(b.shape[1:]) if name in ("convolution", "_convolution") else a.shape[-1]
        f = 2.0 * out_elems * k
        real = nbytes(a) * ratio(a) + nbytes(b) * ratio(b)
        c.update(flops=f, dot_flops=f, bytes=real + out_bytes, bytes_min=real + out_bytes)
        if name in ("addmm", "baddbmm", "addbmm"):
            c["flops"] += out_elems
            c["bytes"] += out_bytes
    elif name in _EW or name.endswith("_backward"):
        c.update(flops=out_elems, bytes=out_bytes)
    elif name in _REDUCE:
        n_in = sum(int(t.numel()) for t in ins)
        c.update(flops=n_in, bytes=in_bytes + out_bytes, bytes_min=in_bytes + out_bytes)
    elif name in _GATHER:
        c.update(bytes=2 * out_bytes, bytes_min=2 * out_bytes)
    elif name in _SCATTER:
        upd = nbytes(ins[-1]) if ins else out_bytes
        c.update(bytes=2 * upd, bytes_min=2 * upd)
    elif name in _CONCAT or name in _SORT:
        c.update(bytes=in_bytes + out_bytes, bytes_min=in_bytes + out_bytes)
        if name in _SORT:
            n = max(int(outs[0].numel()) if outs else 1, 1)
            c["flops"] = n * max(1, int(math.log2(n)))
    else:
        c["bytes"] = out_bytes
    return c


class _EinsumDepth(torch.overrides.TorchFunctionMode):
    """Marks the ops an ``einsum`` runs: a product with no contracted dim
    (or a contraction of size 1) is a ``dot_general`` to the reference,
    which ``torch.einsum`` runs as an elementwise ``mul``."""

    def __init__(self):
        super().__init__()
        self.depth = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func is not torch.einsum:
            return func(*args, **(kwargs or {}))
        self.depth += 1
        try:
            return func(*args, **(kwargs or {}))
        finally:
            self.depth -= 1


class CountingMode(TorchDispatchMode):
    """Counts every ATen op that dispatches inside it (module docstring):
    ``cost``, ``ops`` (calls by op name), ``collectives`` ((kind, result
    bytes) a call), and ``peak_live_bytes`` over the storages the ops make.
    ``args`` are the function's arguments, whose storages are not counted
    as made."""

    def __init__(self, args=(), track_memory: bool = True):
        super().__init__()
        self.track_memory = track_memory
        self.cost = dict(_ZERO)
        self.ops: collections.Counter = collections.Counter()
        self.collectives: List[Tuple[str, int]] = []
        self.live_bytes = 0
        self.peak_live_bytes = 0
        self._live: Dict[int, int] = {}
        self._given = {_key(t) for t in _tensors(args) if not _is_dtensor(t)}
        self._given |= {_key(t.to_local()) for t in _tensors(args) if _is_dtensor(t)}
        self._ratio: Dict[int, float] = {}
        self.einsum = _EinsumDepth()

    def __enter__(self):
        self.einsum.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self.einsum.__exit__(*exc)

    def ratio(self, t: torch.Tensor) -> float:
        """The source-dtype factor of a converted tensor, through its views."""
        return self._ratio.get(_key(t), 1.0)

    def _free(self, key: int, n: int) -> None:
        if self._live.pop(key, None) is not None:
            self.live_bytes -= n

    def _made(self, outs, ins) -> None:
        seen = {_key(t) for t in ins} | self._given
        for t in outs:
            key = _key(t)
            if key in seen or key in self._live:
                continue
            st = t.untyped_storage()
            n = int(st.nbytes())
            self._live[key] = n
            self.live_bytes += n
            self.peak_live_bytes = max(self.peak_live_bytes, self.live_bytes)
            weakref.finalize(st, self._free, key, n)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = op_name(func)
        self.ops[name] += 1
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if name in COLLECTIVE_KINDS:
            self.collectives.append((COLLECTIVE_KINDS[name], sum(nbytes(t) for t in outs)))
        if name == "mul" and self.einsum.depth and all(isinstance(a, torch.Tensor) for a in args[:2]):
            # an einsum's product without a contraction: 2·prod(out) as dot_general
            f = 2.0 * sum(int(t.numel()) for t in outs)
            real = sum(nbytes(a) * self.ratio(a) for a in args[:2])
            cost = dict(flops=f, dot_flops=f, bytes=real + nbytes(outs[0]),
                        bytes_min=real + nbytes(outs[0]))
        elif name in _ALLOC or (outs and ins and not _is_mutating(func)
                                and {_key(t) for t in outs} <= {_key(t) for t in ins}):
            cost = dict(_ZERO)      # a view, or memory not yet written: nothing moves
        else:
            cost = op_cost(name, args, out, self.ratio)
        for k, v in cost.items():
            self.cost[k] += v
        if self.track_memory:
            self._made(outs, ins)
        if name in ("_to_copy", "convert_element_type") and len(outs) == 1 and ins:
            src = ins[0]
            if src.dtype != outs[0].dtype:
                key = _key(outs[0])
                self._ratio[key] = (src.element_size() * self._ratio.get(_key(src), 1.0)
                                    / outs[0].element_size())
                # a storage's key may name a later storage once it dies
                weakref.finalize(outs[0].untyped_storage(), self._ratio.pop, key, None)
        return out


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def to_meta(tree):
    """Every plain tensor of ``tree`` as an empty ``meta`` tensor of its
    shape and dtype (``requires_grad`` kept); other leaves as they are."""
    if isinstance(tree, torch.Tensor) and not _is_dtensor(tree) and tree.device.type != "meta":
        return torch.empty(tree.shape, dtype=tree.dtype, device="meta",
                           requires_grad=tree.requires_grad)
    if isinstance(tree, dict):
        return {k: to_meta(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        vals = [to_meta(v) for v in tree]
        return type(tree)(*vals) if hasattr(tree, "_fields") else type(tree)(vals)
    return tree


def count(fn, *args, track_memory: bool = True) -> Tuple[Any, CountingMode]:
    """``fn(*args)`` run inside a ``CountingMode``: (its output, the mode)."""
    mode = CountingMode(args, track_memory=track_memory)
    with mode:
        out = fn(*args)
    return out, mode


def fn_cost(fn, *args) -> Dict[str, float]:
    """Global logical {"flops", "dot_flops", "bytes", "bytes_min"} of
    ``fn(*args)``, run on ``meta`` tensors (tensor arguments are moved
    there), plus the top-level I/O: inputs read once, outputs written
    once."""
    args = to_meta(args)
    out, mode = count(fn, *args, track_memory=False)
    cost = dict(mode.cost)
    io = sum(nbytes(t) for t in _tensors(args)) + sum(nbytes(t) for t in _tensors(out))
    cost["bytes"] += io
    cost["bytes_min"] += io
    return cost
