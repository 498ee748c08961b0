"""StitchIR for the PyTorch port — the counterpart of ``repro/core/ir.py``.

The graph classes (``Instruction``, ``Module``, ``GraphBuilder``/``Tensor``,
``trace``, ``infer_shape``/``infer_dtype``) are the reference's, with numpy
dtypes throughout: an instruction's ``dtype`` is always an ``np.dtype`` and
becomes a torch dtype only where a tensor is made (``torch_dtype``).
bfloat16, which numpy lacks, is the port's own key ``BFLOAT16``.

``apply_op`` evaluates one instruction on torch tensors with the semantics
of the reference's jnp interpreter.  It is shared by the reference executor,
the runtime's standalone ops and the kernels' plain block interpreters, so
the oracle and the plain kernels agree by construction.  A ``call`` loop
runs its body module's interpreter once per iteration (``_apply_call``).
The cross-device collectives are a later slice of the port and raise
``NotImplementedError`` naming the ROADMAP item.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

# --------------------------------------------------------------------------
# Op taxonomy (paper §2.1)
# --------------------------------------------------------------------------


def _softplus(x):
    # jax.nn.softplus is logaddexp(x, 0); torch's softplus thresholds at 20
    return torch.logaddexp(x, torch.zeros_like(x))


ELEMENTWISE_UNARY: Dict[str, Callable] = {
    "exp": torch.exp,
    "log": torch.log,
    "neg": torch.neg,
    "abs": torch.abs,
    "tanh": torch.tanh,
    "sqrt": torch.sqrt,
    "rsqrt": torch.rsqrt,
    "sigmoid": torch.sigmoid,
    "softplus": _softplus,
    "sign": torch.sign,
    "floor": torch.floor,
    "not": torch.logical_not,
    "silu": F.silu,
    # jax.nn.gelu defaults to approximate=True: the tanh form, not erf
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "square": torch.square,
    "reciprocal": lambda x: 1.0 / x,
    "cos": torch.cos,
    "sin": torch.sin,
}

ELEMENTWISE_BINARY: Dict[str, Callable] = {
    "add": torch.add,
    "sub": torch.sub,
    "mul": torch.mul,
    "div": torch.true_divide,
    "max": torch.maximum,
    "min": torch.minimum,
    "pow": torch.pow,
    "lt": torch.lt,
    "le": torch.le,
    "gt": torch.gt,
    "ge": torch.ge,
    "eq": torch.eq,
    "ne": torch.ne,
    "and": torch.logical_and,
    "or": torch.logical_or,
}

EXPENSIVE_ELEMENTWISE = frozenset(
    {
        "exp", "log", "div", "tanh", "sqrt", "rsqrt", "sigmoid", "softplus",
        "pow", "silu", "gelu", "reciprocal", "cos", "sin",
    }
)

# Cross-device collectives: schedule breaks, never fused (see the reference).
COLLECTIVE_OPCODES = frozenset({"all_reduce", "all_gather", "reduce_scatter"})

_COMPARE_FNS = frozenset({"lt", "le", "gt", "ge", "eq", "ne", "and", "or", "not"})

# the ROADMAP.md queue 1 item that ports what the port still leaves out
SHARDING_ITEM = "ROADMAP.md queue 1, item 14 (sharding and distributed)"

#: the IR's bfloat16.  numpy has none (the reference takes ml_dtypes', a
#: package the port does not depend on), so the port keys it by a 2-byte
#: structured dtype of its own: ``np.dtype`` accepts it and gives its
#: itemsize, so the planner sizes it as the reference sizes bf16, and it
#: equals no other dtype.  Its values live in float32 arrays (``as_array``)
#: and in ``torch.bfloat16`` tensors.
BFLOAT16 = np.dtype([("bfloat16", "<u2")])

_TORCH_DTYPES = {
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
    np.dtype(np.float16): torch.float16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.bool_): torch.bool,
    BFLOAT16: torch.bfloat16,
}


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a numpy dtype (the IR keeps numpy dtypes)."""
    try:
        return _TORCH_DTYPES[np.dtype(dtype)]
    except KeyError:
        raise TypeError(f"dtype {np.dtype(dtype)} has no torch counterpart here") from None


def dtype_name(dtype) -> str:
    """The dtype's name as jnp spells it (``bfloat16`` for ``BFLOAT16``)."""
    dt = np.dtype(dtype)
    return "bfloat16" if dt == BFLOAT16 else dt.name


def as_dtype(dtype) -> np.dtype:
    """A dtype given by object or by name (a ``call``'s ``out_dtypes``), with
    ``"bfloat16"`` as ``BFLOAT16``: ``dtype_name``'s inverse."""
    if isinstance(dtype, str) and dtype == "bfloat16":
        return BFLOAT16
    dt = np.dtype(dtype)
    return BFLOAT16 if dt.name == "bfloat16" else dt


def as_array(value, dtype) -> np.ndarray:
    """``value`` as a numpy array of ``dtype``'s values: ``np.asarray`` for
    every dtype but ``BFLOAT16``, whose values, rounded to nearest even,
    come back in a float32 array."""
    if np.dtype(dtype) != BFLOAT16:
        return np.asarray(value, dtype=dtype)
    f32 = torch.as_tensor(np.asarray(value, dtype=np.float32))
    return f32.to(torch.bfloat16).to(torch.float32).numpy()


def _prod(xs: Sequence[int]) -> int:
    out = 1
    for x in xs:
        out *= int(x)
    return out


# --------------------------------------------------------------------------
# Instruction
# --------------------------------------------------------------------------

_uid = itertools.count()


@dataclass(eq=False)
class Instruction:
    opcode: str
    shape: Tuple[int, ...]
    dtype: Any
    operands: List["Instruction"] = field(default_factory=list)
    attrs: Dict[str, Any] = field(default_factory=dict)
    name: str = ""
    id: int = field(default_factory=lambda: next(_uid))
    users: List["Instruction"] = field(default_factory=list, repr=False)

    def __post_init__(self):
        if not self.name:
            tag = self.attrs.get("fn", self.attrs.get("kind", self.opcode))
            self.name = f"{tag}.{self.id}"
        for op in self.operands:
            op.users.append(self)

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def num_elements(self) -> int:
        return _prod(self.shape)

    @property
    def bytesize(self) -> int:
        return self.num_elements * np.dtype(self.dtype).itemsize

    @property
    def is_elementwise(self) -> bool:
        return self.opcode in ("elementwise", "select")

    @property
    def is_expensive(self) -> bool:
        return (
            self.opcode == "elementwise"
            and self.attrs.get("fn") in EXPENSIVE_ELEMENTWISE
        )

    @property
    def is_library_call(self) -> bool:
        """True for dots the user did NOT mark fusable (cuBLAS analogue)."""
        return self.opcode == "dot" and not self.attrs.get("fusable", False)

    @property
    def is_collective(self) -> bool:
        return self.opcode in COLLECTIVE_OPCODES

    def footprint_bytes(self) -> int:
        """Memory IO footprint: bytes read + bytes written (paper Fig. 1)."""
        return self.bytesize + sum(o.bytesize for o in self.operands)

    def __hash__(self):
        return self.id

    def __repr__(self):
        ops = ", ".join(o.name for o in self.operands)
        attrs = self.attrs
        if self.opcode == "call":
            # the body Module (and its compiled form) would render multiline
            attrs = {
                "kind": attrs.get("kind"),
                "body": getattr(attrs.get("body"), "name", None),
                "trip_count": attrs.get("trip_count"),
                "num_carry": attrs.get("num_carry"),
                "reverse": attrs.get("reverse"),
            }
        return (
            f"%{self.name}: {dtype_name(self.dtype)}{list(self.shape)} = "
            f"{self.opcode}({ops}) {attrs or ''}"
        )


# --------------------------------------------------------------------------
# Module
# --------------------------------------------------------------------------


class Module:
    """A StitchIR computation graph. Instructions are stored topologically
    (creation order — operands always precede users)."""

    def __init__(self, name: str = "module"):
        self.name = name
        self.instructions: List[Instruction] = []
        self.parameters: List[Instruction] = []

    def add(self, instr: Instruction) -> Instruction:
        if instr.opcode == "parameter":
            if any(p.name == instr.name for p in self.parameters):
                raise ValueError(
                    f"duplicate parameter name {instr.name!r} in module "
                    f"{self.name!r} — parameter names key the feed dict, so "
                    "a later parameter would silently shadow the earlier one"
                )
            self.parameters.append(instr)
        self.instructions.append(instr)
        return instr

    @property
    def roots(self) -> List[Instruction]:
        """Sink instructions (no users) — the module outputs."""
        return [i for i in self.instructions if not i.users]

    def verify(self) -> None:
        """Full IR well-formedness check, delegated to the verifier's IR
        family (``core/verify.py``).  Raises ``VerificationError`` (a
        ``ValueError``) on the first batch of violations."""
        from .verify import ERROR, VerificationError, verify_module

        diags = [d for d in verify_module(self) if d.severity == ERROR]
        if diags:
            raise VerificationError(diags)

    def __repr__(self):
        lines = [f"module {self.name} {{"]
        lines += [f"  {i!r}" for i in self.instructions]
        lines.append("}")
        return "\n".join(lines)


def infer_shape(opcode, operand_shapes, attrs) -> Optional[Tuple[int, ...]]:
    if opcode in ("parameter", "constant", "iota"):
        return None  # shape is intrinsic
    if opcode in ("call", "get"):
        return None  # multi-output loop call / projection: shapes in attrs
    if opcode == "elementwise":
        return tuple(operand_shapes[0])
    if opcode == "select":
        return tuple(operand_shapes[1])
    if opcode in ("reshape", "bitcast"):
        return tuple(attrs["new_shape"])
    if opcode == "transpose":
        perm = attrs["perm"]
        s = operand_shapes[0]
        return tuple(s[p] for p in perm)
    if opcode == "broadcast":
        return tuple(attrs["out_shape"])
    if opcode == "reduce":
        dims = set(attrs["dims"])
        return tuple(d for i, d in enumerate(operand_shapes[0]) if i not in dims)
    if opcode == "dot":
        lhs, rhs = operand_shapes
        assert lhs[:-2] == rhs[:-2], f"batch dims mismatch {lhs} x {rhs}"
        assert lhs[-1] == rhs[-2], f"contract mismatch {lhs} x {rhs}"
        return tuple(lhs[:-1]) + (rhs[-1],)
    if opcode == "concat":
        dim = attrs["dim"]
        out = list(operand_shapes[0])
        out[dim] = sum(s[dim] for s in operand_shapes)
        return tuple(out)
    if opcode == "gather":
        table, idx = operand_shapes
        return tuple(idx) + tuple(table[1:])
    if opcode == "all_reduce":
        return tuple(operand_shapes[0])
    if opcode == "all_gather":
        s = list(operand_shapes[0])
        s[attrs["dim"]] *= int(attrs["group_size"])
        return tuple(s)
    if opcode == "reduce_scatter":
        s = list(operand_shapes[0])
        dim, g = attrs["dim"], int(attrs["group_size"])
        if s[dim] % g:
            raise ValueError(
                f"reduce_scatter dim {dim} of size {s[dim]} not divisible by "
                f"group size {g}"
            )
        s[dim] //= g
        return tuple(s)
    raise ValueError(f"unknown opcode {opcode}")


def infer_dtype(opcode, operand_dtypes, attrs) -> Optional[Any]:
    """The dtype counterpart of ``infer_shape`` (see the reference)."""
    if opcode in ("parameter", "constant", "iota", "call", "get"):
        return None  # intrinsic / declared in attrs
    if opcode == "elementwise":
        fn = attrs.get("fn")
        if fn in _COMPARE_FNS:
            return np.dtype(bool)
        if fn == "convert":
            return None  # cast target IS the instruction's own dtype
        return np.dtype(operand_dtypes[0])
    if opcode == "select":
        return np.dtype(operand_dtypes[1])
    if not operand_dtypes:
        return None
    return np.dtype(operand_dtypes[0])


# --------------------------------------------------------------------------
# The single-op torch interpreter (shared oracle <-> plain kernels)
# --------------------------------------------------------------------------


def broadcast_in_dim(v: torch.Tensor, out_shape, dims) -> torch.Tensor:
    """XLA ``broadcast_in_dim``: operand dim j maps to output dim dims[j]."""
    view = [1] * len(out_shape)
    for j, d in enumerate(dims):
        view[d] = v.shape[j]
    return v.reshape(view).expand(tuple(out_shape))


def iota(shape, dim: int, dtype, device) -> torch.Tensor:
    """``lax.broadcasted_iota``: the index along ``dim``, broadcast to shape."""
    shape = tuple(shape)
    ar = torch.arange(shape[dim], device=device).to(torch_dtype(dtype))
    return broadcast_in_dim(ar, shape, (dim,)).contiguous()


def take_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``jnp.take(table, idx, axis=0)`` in its default "fill" mode: indices
    in [-n, n) wrap like Python's, any other index yields a fill row (NaN
    for floats, the most negative value for signed ints, the largest for
    unsigned ints, True for bool)."""
    n = table.shape[0]
    idx = idx.to(torch.int64)
    valid = (idx >= -n) & (idx < n)
    rows = table[torch.where(valid, torch.remainder(idx, max(n, 1)), 0)]
    if table.dtype.is_floating_point:
        fill = float("nan")
    elif table.dtype == torch.bool:
        fill = True
    elif table.dtype.is_signed:
        fill = torch.iinfo(table.dtype).min
    else:   # jnp fills unsigned rows with the largest value
        fill = torch.iinfo(table.dtype).max
    mask = valid.reshape(tuple(valid.shape) + (1,) * (table.ndim - 1))
    return torch.where(mask, rows, torch.full_like(rows, fill))


def convert(v: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``astype`` as jnp does it: a float becomes an int by truncation, NaN
    gives 0 and values out of range saturate (torch's cast would wrap)."""
    if not v.dtype.is_floating_point or dtype.is_floating_point or dtype == torch.bool:
        return v.to(dtype)
    info = torch.iinfo(dtype)
    x = torch.nan_to_num(v.to(torch.float64), nan=0.0)
    lo, hi = float(info.min), float(info.max)   # int64's hi rounds up to 2**63
    out = torch.where((x > lo) & (x < hi), x, torch.zeros_like(x)).to(dtype)
    out = torch.where(x >= hi, torch.full_like(out, info.max), out)
    return torch.where(x <= lo, torch.full_like(out, info.min), out)


def _reduce(v: torch.Tensor, dims: Tuple[int, ...], kind: str) -> torch.Tensor:
    if not dims:
        return v  # jnp reductions over no axes are the identity
    if kind == "sum":
        return torch.sum(v, dim=dims)
    if kind == "max":
        return torch.amax(v, dim=dims)
    if kind == "min":
        return torch.amin(v, dim=dims)
    if kind == "mean":
        return torch.mean(v, dim=dims)
    if kind == "prod":
        for d in sorted(dims, reverse=True):
            v = torch.prod(v, dim=d)
        return v
    raise ValueError(f"unknown reduce kind {kind}")


def apply_op(instr: Instruction, *vals, device=None):
    """Evaluate one instruction given operand tensors (full arrays in the
    reference executor; block tiles inside the plain kernel interpreters).

    ``device`` places operand-free results (constants, iota), and defaults
    to the first operand's device, else the CPU.
    """
    op = instr.opcode
    a = instr.attrs
    if device is None:
        device = vals[0].device if vals else "cpu"
    out = _apply(instr, op, a, vals, device)
    if op == "call":
        return out    # every logical output, projected by ``get``
    want = torch_dtype(instr.dtype)
    # torch widens where jnp keeps the dtype (int32 sums become int64)
    return out if out.dtype == want else out.to(want)


def _apply(instr, op, a, vals, device):
    if op == "elementwise":
        fn = a["fn"]
        if fn == "convert":
            return convert(vals[0], torch_dtype(instr.dtype))
        if fn in ELEMENTWISE_UNARY:
            return ELEMENTWISE_UNARY[fn](vals[0])
        return ELEMENTWISE_BINARY[fn](vals[0], vals[1])
    if op == "select":
        return torch.where(vals[0].to(torch.bool), vals[1], vals[2])
    if op in ("reshape", "bitcast"):
        return torch.reshape(vals[0], tuple(a["new_shape"]))
    if op == "transpose":
        return vals[0].permute(tuple(a["perm"]))
    if op == "broadcast":
        return broadcast_in_dim(vals[0], a["out_shape"], a["dims"])
    if op == "reduce":
        return _reduce(vals[0], tuple(a["dims"]), a["kind"])
    if op == "dot":
        # full f32 products (the reference asks dot_general for f32 results)
        return torch.matmul(vals[0], vals[1])
    if op == "concat":
        return torch.cat(list(vals), dim=a["dim"])
    if op == "gather":
        return take_rows(vals[0], vals[1])
    if op == "iota":
        return iota(instr.shape, a["dim"], instr.dtype, device)
    if op == "constant":
        arr = as_array(a["value"], instr.dtype)
        return torch.as_tensor(arr, device=device).to(torch_dtype(instr.dtype))
    if op == "call":
        return _apply_call(instr, vals)
    if op == "get":
        return vals[0][a["index"]]
    if op in COLLECTIVE_OPCODES:
        raise NotImplementedError(f"collective {op!r} is ported by {SHARDING_ITEM}")
    raise ValueError(f"cannot apply {op}")


def _interpret_module(module: "Module", feeds_by_order: Sequence, device) -> List[torch.Tensor]:
    """Reference walk of a (loop-body) module with parameter values given
    positionally in parameter-creation order; the root values in
    ``module.roots`` order."""
    vals: Dict[int, torch.Tensor] = {}
    params = iter(feeds_by_order)
    for instr in module.instructions:
        if instr.opcode == "parameter":
            vals[instr.id] = torch.as_tensor(next(params), device=device).to(torch_dtype(instr.dtype))
        else:
            vals[instr.id] = apply_op(instr, *[vals[o.id] for o in instr.operands], device=device)
    return [vals[r.id] for r in module.roots]


def _apply_call(instr: Instruction, vals) -> Tuple[torch.Tensor, ...]:
    """Reference semantics of a ``call`` loop: run the body module
    ``trip_count`` times threading carries, stack the per-iteration outputs
    (in reverse order of iteration where ``reverse``).  Returns ALL logical
    outputs ``(carries..., stacked ys...)``; ``get`` projects one."""
    a = instr.attrs
    body: "Module" = a["body"]
    nc, k = int(a["num_consts"]), int(a["num_carry"])
    trip = int(a["trip_count"])
    reverse = bool(a.get("reverse", False))
    out_order = list(a["out_order"])           # logical output -> root pos
    device = vals[0].device if vals else "cpu"
    consts = list(vals[:nc])
    carry = list(vals[nc:nc + k])
    xs = list(vals[nc + k:])
    n_y = len(out_order) - k
    ys: List[List[torch.Tensor]] = [[] for _ in range(n_y)]
    steps = range(trip - 1, -1, -1) if reverse else range(trip)
    for t in steps:
        roots = _interpret_module(body, consts + carry + [x[t] for x in xs], device)
        ordered = [roots[j] for j in out_order]
        carry = ordered[:k]
        for j in range(n_y):
            ys[j].append(ordered[k + j])
    if reverse:
        ys = [list(reversed(col)) for col in ys]
    stacked = []
    for j in range(n_y):
        if ys[j]:
            stacked.append(torch.stack(ys[j]))
        else:  # zero-trip loop: empty stacked output
            dt = torch_dtype(as_dtype(a["out_dtypes"][k + j]))
            stacked.append(torch.zeros(tuple(a["out_shapes"][k + j]), dtype=dt, device=device))
    return tuple(carry + stacked)


# --------------------------------------------------------------------------
# GraphBuilder + Tensor tracing frontend
# --------------------------------------------------------------------------


class Tensor:
    """A traced handle; supports jnp-style operator overloading."""

    __slots__ = ("builder", "instr")
    __array_priority__ = 100  # beat numpy broadcasting

    def __init__(self, builder: "GraphBuilder", instr: Instruction):
        self.builder = builder
        self.instr = instr

    @property
    def shape(self):
        return self.instr.shape

    @property
    def dtype(self):
        return self.instr.dtype

    @property
    def ndim(self):
        return len(self.instr.shape)

    def _b(self, other, fn, reverse=False):
        other = self.builder.lift(other, like=self)
        lhs, rhs = (other, self) if reverse else (self, other)
        return self.builder.binary(fn, lhs, rhs)

    def __add__(self, o): return self._b(o, "add")
    def __radd__(self, o): return self._b(o, "add", True)
    def __sub__(self, o): return self._b(o, "sub")
    def __rsub__(self, o): return self._b(o, "sub", True)
    def __mul__(self, o): return self._b(o, "mul")
    def __rmul__(self, o): return self._b(o, "mul", True)
    def __truediv__(self, o): return self._b(o, "div")
    def __rtruediv__(self, o): return self._b(o, "div", True)
    def __pow__(self, o): return self._b(o, "pow")
    def __neg__(self): return self.builder.unary("neg", self)
    def __lt__(self, o): return self._b(o, "lt")
    def __le__(self, o): return self._b(o, "le")
    def __gt__(self, o): return self._b(o, "gt")
    def __ge__(self, o): return self._b(o, "ge")

    def reshape(self, *shape):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        return self.builder.reshape(self, shape)

    def transpose(self, perm):
        return self.builder.transpose(self, perm)

    def sum(self, dims, keepdims=False):
        return self.builder.reduce(self, dims, "sum", keepdims=keepdims)

    def max(self, dims, keepdims=False):
        return self.builder.reduce(self, dims, "max", keepdims=keepdims)

    def __repr__(self):
        return f"Tensor({self.instr.name}: {dtype_name(self.dtype)}{list(self.shape)})"


class GraphBuilder:
    def __init__(self, name: str = "module"):
        self.module = Module(name)

    def _emit(self, opcode, shape, dtype, operands=(), attrs=None, name="") -> Tensor:
        instr = Instruction(
            opcode,
            tuple(int(s) for s in shape),
            np.dtype(dtype),
            [t.instr for t in operands],
            dict(attrs or {}),
            name=name,
        )
        self.module.add(instr)
        return Tensor(self, instr)

    def parameter(self, name, shape, dtype=np.float32) -> Tensor:
        return self._emit("parameter", shape, dtype, name=name)

    def constant(self, value, dtype=None) -> Tensor:
        arr = as_array(value, dtype) if dtype is not None else np.asarray(value)
        dt = BFLOAT16 if dtype is not None and np.dtype(dtype) == BFLOAT16 else arr.dtype
        return self._emit("constant", arr.shape, dt, attrs={"value": arr})

    def lift(self, value, like: Tensor) -> Tensor:
        """Lift a python scalar / ndarray to a Tensor broadcast to ``like``."""
        if isinstance(value, Tensor):
            if value.shape == like.shape:
                return value
            if value.ndim == 0:
                return self.broadcast(value, like.shape, dims=())
            raise ValueError(f"shape mismatch {value.shape} vs {like.shape}")
        arr = as_array(value, like.dtype)
        c = self.constant(arr, like.dtype)
        if arr.shape == tuple(like.shape):
            return c
        if arr.ndim == 0:
            return self.broadcast(c, like.shape, dims=())
        raise ValueError(f"cannot lift shape {arr.shape} to {like.shape}")

    def unary(self, fn, x: Tensor) -> Tensor:
        dtype = np.bool_ if fn in _COMPARE_FNS else x.dtype
        return self._emit("elementwise", x.shape, dtype, [x], {"fn": fn})

    def binary(self, fn, x: Tensor, y: Tensor) -> Tensor:
        assert tuple(x.shape) == tuple(y.shape), f"{fn}: {x.shape} vs {y.shape}"
        dtype = np.bool_ if fn in _COMPARE_FNS else x.dtype
        return self._emit("elementwise", x.shape, dtype, [x, y], {"fn": fn})

    def select(self, pred: Tensor, t: Tensor, f: Tensor) -> Tensor:
        return self._emit("select", t.shape, t.dtype, [pred, t, f])

    def convert(self, x: Tensor, dtype) -> Tensor:
        """Elementwise dtype cast; identity when the dtype already matches."""
        dtype = np.dtype(dtype)
        if np.dtype(x.dtype) == dtype:
            return x
        return self._emit("elementwise", x.shape, dtype, [x], {"fn": "convert"})

    def reshape(self, x: Tensor, new_shape) -> Tensor:
        new_shape = tuple(int(s) for s in new_shape)
        assert _prod(new_shape) == x.instr.num_elements
        return self._emit("reshape", new_shape, x.dtype, [x], {"new_shape": new_shape})

    def bitcast(self, x: Tensor, new_shape) -> Tensor:
        new_shape = tuple(int(s) for s in new_shape)
        assert _prod(new_shape) == x.instr.num_elements
        return self._emit("bitcast", new_shape, x.dtype, [x], {"new_shape": new_shape})

    def transpose(self, x: Tensor, perm) -> Tensor:
        perm = tuple(perm)
        shape = tuple(x.shape[p] for p in perm)
        return self._emit("transpose", shape, x.dtype, [x], {"perm": perm})

    def broadcast(self, x: Tensor, out_shape, dims) -> Tensor:
        out_shape, dims = tuple(out_shape), tuple(dims)
        for i, d in enumerate(dims):
            assert x.shape[i] in (1, out_shape[d])
        return self._emit(
            "broadcast", out_shape, x.dtype, [x], {"out_shape": out_shape, "dims": dims}
        )

    def broadcast_like(self, x: Tensor, like: Tensor, dims) -> Tensor:
        return self.broadcast(x, like.shape, dims)

    def reduce(self, x: Tensor, dims, kind="sum", keepdims=False) -> Tensor:
        if isinstance(dims, int):
            dims = (dims,)
        dims = tuple(sorted(d % x.ndim for d in dims))
        out_shape = tuple(s for i, s in enumerate(x.shape) if i not in dims)
        r = self._emit("reduce", out_shape, x.dtype, [x], {"dims": dims, "kind": kind})
        if keepdims:
            kept = [i for i in range(x.ndim) if i not in dims]
            r = self.broadcast(r, tuple(s if i not in dims else 1 for i, s in enumerate(x.shape)), tuple(kept))
        return r

    def dot(self, lhs: Tensor, rhs: Tensor, fusable=False) -> Tensor:
        shape = infer_shape("dot", [lhs.shape, rhs.shape], {})
        return self._emit("dot", shape, lhs.dtype, [lhs, rhs], {"fusable": fusable})

    def concat(self, xs: Sequence[Tensor], dim: int) -> Tensor:
        shape = infer_shape("concat", [x.shape for x in xs], {"dim": dim})
        return self._emit("concat", shape, xs[0].dtype, list(xs), {"dim": dim})

    def gather(self, table: Tensor, idx: Tensor) -> Tensor:
        shape = tuple(idx.shape) + tuple(table.shape[1:])
        return self._emit("gather", shape, table.dtype, [table, idx])

    def iota(self, shape, dim=0, dtype=np.float32) -> Tensor:
        return self._emit("iota", shape, dtype, [], {"dim": dim})

    def call_loop(
        self,
        operands: Sequence[Tensor],
        body: Module,
        *,
        trip_count: int,
        num_consts: int,
        num_carry: int,
        out_order: Sequence[int],
        out_shapes: Sequence[Tuple[int, ...]],
        out_dtypes: Sequence[Any],
        reverse: bool = False,
        kind: str = "scan",
    ) -> Tensor:
        """A sub-module loop (``lax.scan`` analogue): run ``body``
        ``trip_count`` times.  Operands are ``consts + init_carries +
        stacked xs`` and bind positionally to the body's parameters (in
        creation order).  The instruction's logical outputs are
        ``(final carries..., stacked ys...)``; ``out_order[j]`` locates
        logical output ``j`` among ``body.roots``.  ``out_dtypes`` are kept
        by name (``dtype_name``), as the reference keeps them.  Project
        outputs with ``get``."""
        attrs = {
            "kind": kind,
            "body": body,
            "trip_count": int(trip_count),
            "num_consts": int(num_consts),
            "num_carry": int(num_carry),
            "reverse": bool(reverse),
            "out_order": tuple(int(j) for j in out_order),
            "out_shapes": tuple(tuple(int(s) for s in sh) for sh in out_shapes),
            "out_dtypes": tuple(dtype_name(as_dtype(d)) for d in out_dtypes),
        }
        return self._emit(
            "call", attrs["out_shapes"][0], as_dtype(attrs["out_dtypes"][0]),
            list(operands), attrs,
        )

    def get(self, call: Tensor, index: int) -> Tensor:
        """Project logical output ``index`` of a ``call`` loop."""
        a = call.instr.attrs
        return self._emit(
            "get", a["out_shapes"][index], as_dtype(a["out_dtypes"][index]),
            [call], {"index": int(index)},
        )

    # -- named math sugar ---------------------------------------------------
    def exp(self, x): return self.unary("exp", x)
    def log(self, x): return self.unary("log", x)
    def tanh(self, x): return self.unary("tanh", x)
    def sqrt(self, x): return self.unary("sqrt", x)
    def rsqrt(self, x): return self.unary("rsqrt", x)
    def sigmoid(self, x): return self.unary("sigmoid", x)
    def silu(self, x): return self.unary("silu", x)
    def gelu(self, x): return self.unary("gelu", x)
    def square(self, x): return self.unary("square", x)
    def neg(self, x): return self.unary("neg", x)
    def abs(self, x): return self.unary("abs", x)
    def maximum(self, x, y): return self.binary("max", x, self.lift(y, like=x))
    def minimum(self, x, y): return self.binary("min", x, self.lift(y, like=x))

    def softmax(self, x: Tensor, dim: int = -1) -> Tensor:
        """The paper's Figure-3 pattern: max-sub, exp, reduce, divide."""
        dim = dim % x.ndim
        kept = tuple(i for i in range(x.ndim) if i != dim)
        z = x - self.broadcast(self.reduce(x, (dim,), "max"), x.shape, kept)
        e = self.exp(z)
        s = self.reduce(e, (dim,), "sum")
        return e / self.broadcast(s, x.shape, kept)


def trace(fn: Callable, *specs, name: str = "traced") -> Module:
    """Trace a python function of Tensors into a Module, verified as the
    reference verifies it.  ``specs`` are (name, shape, dtype) triples."""
    b = GraphBuilder(name)
    args = [b.parameter(pname, shape, dtype) for pname, shape, dtype in specs]
    fn(b, *args)
    b.module.verify()
    return b.module
