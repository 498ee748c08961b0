"""``repro_torch.stitch`` — a ``jax.jit``-shaped frontend for the port's
compiler, over PyTorch functions; the counterpart of ``repro/frontend/api.py``.

    from repro_torch import stitch

    @stitch
    def attention(q, k, v):
        s = q @ k.transpose(-1, -2) / q.shape[-1] ** 0.5
        return torch.softmax(s, dim=-1) @ v

    out = attention(q, k, v)        # captured, lowered, compiled, executed
    print(attention.report())       # kernels / fusion ratio / scratch plan

``stitch(fn)`` returns a ``StitchedFunction``: calling it captures ``fn``
into an ATen graph (``capture``: ``make_fx`` of the functionalized function
under the core ATen decompositions, on fresh fake tensors of the
arguments' shapes and dtypes), lowers the graph into StitchIR
(``aten_lower``), runs the unchanged pass pipeline via ``compile_module``
and executes the planned runtime on the plan's device: the card unless the
caller asks for the CPU (``device="cpu"``, where every kernel runs its
plain version).  Compiled plans are cached per input signature (static
values, Python-scalar values, pytree structure, leaf shapes and dtypes), so
repeated calls at the same shapes never recompile, and the per-function
``KernelCache`` and ``MeasuredCostStore`` are shared across signatures.

``jax.jit`` parity surface:

  * ``static_argnums`` / ``static_argnames`` — arguments treated as
    compile-time constants and keyed (by value) into the plan cache;
  * ``donate_argnums`` — positional arguments whose buffers the caller
    relinquishes: the plan may release them at their last read;
  * ``stitched.lower(*args)`` — a ``Lowered`` handle with ``.as_text()``,
    ``.num_kernels`` and ``.cost_estimate()``.

The sharded form ``stitch(fn, mesh=, in_specs=, out_specs=)`` takes ``fn``
as the per-shard body, as ``shard_map`` does: it calls
``torch.distributed._functional_collectives`` with ``(mesh, dim)`` or a
process group.  Every rank of the ``torch.distributed`` world calls the
stitched function with the GLOBAL arguments; local shapes come from
``in_specs`` (one spec per positional argument: ``None``, an axis name or a
tuple of names per dim), ``fn`` is captured at them and lowered by
``lower_sharded_graph``, and the sharded plan returns global outputs
(``out_specs``: one spec for a single output, one per output of a tuple).
"""
from __future__ import annotations

import dataclasses
import functools
import traceback
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.utils._pytree as pytree

from .. import tracing
from ..core.compiler import CompiledModule, CompileStats, StitchOptions, compile_module
from ..core.device import resolve_device
from ..core.ir import Module
from ..core.shard import mesh_axes_of, mesh_sizes, spec_to_layout, wrap_shard_map
from ..core.signature import KernelCache
from .aten_lower import (
    LoweredGraph,
    UnsupportedPrimitiveError,
    lower_graph,
    lower_sharded_graph,
)

_FALLBACK_MODES = ("error", "fallback")


@dataclass
class _PlanEntry:
    """One compiled (or fallen-back) plan for one input signature.
    ``tensor_leaves`` are the flattened-argument positions that are tensors
    (the module's parameters, in order); the other leaves are Python values
    baked into the plan."""

    lowered: Optional[LoweredGraph]      # None => fallback entry
    compiled: Optional[CompiledModule]
    out_spec: Any
    tensor_leaves: Tuple[int, ...] = ()

    @property
    def is_fallback(self) -> bool:
        return self.lowered is None


def _is_tensor_leaf(leaf) -> bool:
    return isinstance(leaf, (torch.Tensor, np.ndarray, np.generic))


def _as_tensor(leaf) -> torch.Tensor:
    """A tensor leaf as a torch tensor (numpy arrays and scalars across by
    ``torch.as_tensor``), on the device it already lies on."""
    return leaf if isinstance(leaf, torch.Tensor) else torch.as_tensor(np.asarray(leaf))


def _leaf_key(leaf):
    if _is_tensor_leaf(leaf):
        t = _as_tensor(leaf)
        return ("tensor", tuple(t.shape), str(t.dtype))
    # a Python value is baked into the captured graph: its plan is its own
    if not _hashable(leaf):
        raise TypeError(
            f"argument leaf of type {type(leaf).__name__} is neither a tensor nor "
            "a hashable Python value"
        )
    return ("value", type(leaf).__name__, leaf)


def _int_tuple(v, label: str) -> Tuple[int, ...]:
    if v is None:
        return ()
    if isinstance(v, int):
        v = (v,)
    out = tuple(v)
    if not all(isinstance(i, int) for i in out):
        raise TypeError(f"{label} must be an int or a sequence of ints: {v!r}")
    return out


def _str_tuple(v, label: str) -> Tuple[str, ...]:
    if v is None:
        return ()
    if isinstance(v, str):
        v = (v,)
    out = tuple(v)
    if not all(isinstance(s, str) for s in out):
        raise TypeError(f"{label} must be a str or a sequence of strs: {v!r}")
    return out


def _hashable(v) -> bool:
    try:
        hash(v)
        return True
    except TypeError:
        return False


def _collect_modules(module: Module, acc: List[Module], seen: set) -> None:
    if id(module) in seen:
        return
    seen.add(id(module))
    acc.append(module)
    for instr in module.instructions:
        if instr.opcode == "call":
            _collect_modules(instr.attrs["body"], acc, seen)


def _failed_higher_order_op(exc: BaseException) -> str:
    """The higher-order op whose capture raised ``exc``: the innermost
    frame in ``torch/_higher_order_ops/<op>.py``, as ``higher_order.<op>``."""
    name = "capture"
    for frame in traceback.extract_tb(exc.__traceback__):
        path = frame.filename.replace("\\", "/")
        if "/_higher_order_ops/" in path:
            mod = path.rsplit("/", 1)[-1][:-3]
            if mod != "utils":
                name = f"higher_order.{mod}"
    return name


def _decompositions() -> dict:
    """The core ATen decompositions but ``select_scatter``'s, which
    ``aten_lower`` lowers as a write into a row (torch's would compare an
    iota with the row's index in every element)."""
    from torch._decomp import core_aten_decompositions

    table = core_aten_decompositions()
    table.pop(torch.ops.aten.select_scatter.default, None)
    return table


def capture(fn: Callable, leaves: Sequence, in_spec) -> Tuple[torch.fx.GraphModule, Any]:
    """Capture ``fn`` over the flattened argument ``leaves`` (of structure
    ``in_spec``) into an ATen graph; returns the graph and the output
    pytree spec.

    The graph's placeholders are the tensor leaves, in order; the other
    leaves (Python values) are baked in.  The capture runs ``make_fx`` on
    the functionalized function (no in-place op survives it) with the core
    ATen decompositions and ``tracing_mode="fake"``, over a fresh CPU tensor
    per tensor leaf: never the caller's tensors, so one tensor passed twice
    still captures two placeholders, and no device is baked into the plan.
    A failure inside a higher-order op (torch cannot capture the gradient
    of a ``scan``) raises ``UnsupportedPrimitiveError`` naming the op."""
    import torch._dynamo
    from torch._dynamo.exc import Unsupported
    from torch.fx.experimental.proxy_tensor import make_fx

    tensor_pos = [i for i, leaf in enumerate(leaves) if _is_tensor_leaf(leaf)]
    out_spec: List[Any] = []

    def flat_fn(*tensors):
        full = list(leaves)
        for i, t in zip(tensor_pos, tensors, strict=True):
            full[i] = t
        args, kwargs = pytree.tree_unflatten(full, in_spec)
        outs, spec = pytree.tree_flatten(fn(*args, **kwargs))
        out_spec.append(spec)
        return outs

    examples = []
    for i in tensor_pos:
        t = _as_tensor(leaves[i])
        examples.append(torch.empty(tuple(t.shape), dtype=t.dtype))
    try:
        # static shapes throughout: a higher-order op's body is traced by
        # dynamo, whose automatic dynamic shapes would otherwise turn a
        # size seen twice with two values into a symbolic loop input
        with torch._dynamo.config.patch(automatic_dynamic_shapes=False,
                                        assume_static_by_default=True):
            gm = make_fx(
                torch.func.functionalize(flat_fn, remove="mutations"),
                decomposition_table=_decompositions(),
                tracing_mode="fake",
                _allow_non_fake_inputs=True,
                record_stack_traces=True,
            )(*examples)
    except Unsupported as e:
        raise UnsupportedPrimitiveError(
            _failed_higher_order_op(e), None, f"torch cannot capture it here: {e}".split("\n")[0]
        ) from e
    return gm, out_spec[-1]


@dataclass(frozen=True)
class CostEstimate:
    """Latency estimate for one compiled plan.

    ``analytic_s`` is the pure roofline-model prediction; ``measured_s``
    substitutes on-device timings for the ``measured_kernels`` stitched
    kernels the tuning store had rows for (None when nothing was measured).
    """

    analytic_s: float
    measured_s: Optional[float]
    measured_kernels: int
    num_kernels: int


class Lowered:
    """``jax.jit``-style lowering handle: the captured StitchIR plus lazy
    compilation for introspection (``.as_text()``, ``.num_kernels``,
    ``.cost_estimate()``).  Unknown attributes delegate to ``.module``, so
    ``.parameters`` / ``.instructions`` read the module."""

    def __init__(self, lowered: LoweredGraph, compile_thunk: Callable[[], CompiledModule],
                 compiled: Optional[CompiledModule] = None):
        self._lowered = lowered
        self._compile_thunk = compile_thunk
        self._compiled = compiled

    @property
    def module(self) -> Module:
        return self._lowered.module

    @property
    def param_names(self) -> List[str]:
        return list(self._lowered.param_names)

    def as_text(self) -> str:
        """The module text, loop-body sub-modules appended."""
        mods: List[Module] = []
        _collect_modules(self.module, mods, set())
        return "\n\n".join(repr(m) for m in mods)

    def compile(self) -> CompiledModule:
        if self._compiled is None:
            self._compiled = self._compile_thunk()
        return self._compiled

    @property
    def num_kernels(self) -> int:
        """Total kernels this plan launches code for: stitched + standalone
        + kernels inside unique loop bodies (library dots excluded, as in
        ``CompileStats``)."""
        s = self.compile().stats
        return s.stitched_kernels + s.standalone_kernels + s.sub_kernels

    def cost_estimate(self) -> CostEstimate:
        s = self.compile().stats
        # remainder = standalone ops, library calls, loop bodies — costs not
        # itemized in per-kernel reports
        remainder = s.predicted_time_s - sum(r.cost_s for r in s.reports)
        analytic = remainder + sum(
            r.model_cost_s if r.model_cost_s is not None else r.cost_s for r in s.reports
        )
        n_meas = sum(1 for r in s.reports if r.measured_cost_s is not None)
        measured = None
        if n_meas:
            measured = remainder + sum(
                r.measured_cost_s if r.measured_cost_s is not None
                else (r.model_cost_s if r.model_cost_s is not None else r.cost_s)
                for r in s.reports
            )
        return CostEstimate(analytic_s=analytic, measured_s=measured,
                            measured_kernels=n_meas, num_kernels=self.num_kernels)

    def __getattr__(self, name):
        return getattr(self._lowered.module, name)

    def __repr__(self):
        return f"Lowered({self.module.name}, {len(self.module.instructions)} instructions)"


class StitchedFunction:
    """A PyTorch function captured into StitchIR and compiled per input
    signature.

    Attributes/methods of note:
      * ``.options``       — the ``StitchOptions`` this function compiles under
      * ``.device``        — where plans run (None: the card)
      * ``.stats``         — ``CompileStats`` of the most recent compile
      * ``.lower(*args)``  — a ``Lowered`` introspection handle (no execute)
      * ``.report()``      — human-readable compile report
      * ``.num_compiles`` / ``.num_fallbacks`` — plan-cache accounting
      * ``.capture_s`` / ``.lower_s`` — host seconds of the latest capture
        and lowering
    """

    def __init__(
        self,
        fn: Callable,
        options: Optional[StitchOptions] = None,
        on_unsupported: str = "error",
        name: Optional[str] = None,
        static_argnums: Union[int, Sequence[int], None] = (),
        static_argnames: Union[str, Sequence[str], None] = (),
        donate_argnums: Union[int, Sequence[int], None] = (),
        device=None,
        mesh=None,
        in_specs=None,
        out_specs=None,
    ):
        if not callable(fn):
            raise TypeError(f"stitch() requires a callable, got {type(fn).__name__}")
        if on_unsupported not in _FALLBACK_MODES:
            raise ValueError(
                f"on_unsupported={on_unsupported!r}; valid modes: {', '.join(_FALLBACK_MODES)}"
            )
        self._fn = fn
        self.options = options if options is not None else StitchOptions()
        self.mesh = mesh
        self.in_specs = tuple(in_specs) if in_specs is not None else None
        self.out_specs = out_specs
        self.on_unsupported = on_unsupported
        self.name = name or getattr(fn, "__name__", "stitched")
        if self.name == "<lambda>":
            self.name = "stitched"
        self.device = device
        self.static_argnums = _int_tuple(static_argnums, "static_argnums")
        self.static_argnames = _str_tuple(static_argnames, "static_argnames")
        self.donate_argnums = _int_tuple(donate_argnums, "donate_argnums")
        overlap = set(self.static_argnums) & set(self.donate_argnums)
        if overlap:
            raise ValueError(
                f"static_argnums and donate_argnums cannot intersect: {sorted(overlap)}"
            )
        if mesh is not None:
            if in_specs is None or out_specs is None:
                raise ValueError(
                    "stitch(mesh=...) needs in_specs and out_specs: the placement of "
                    "every argument and output"
                )
            if self.static_argnums or self.static_argnames or self.donate_argnums:
                raise ValueError(
                    "stitch(mesh=...) does not compose with static_argnums/"
                    "static_argnames/donate_argnums yet"
                )
            if not self.options.mesh_axes:
                self.options = dataclasses.replace(self.options, mesh_axes=mesh_axes_of(mesh))
        elif in_specs is not None or out_specs is not None:
            raise ValueError("in_specs/out_specs require mesh=...")
        self._plans: Dict[Any, _PlanEntry] = {}
        self._kernel_cache = KernelCache(self.options.kernel_cache_path)
        # Shared across this function's per-shape compiles (like the kernel
        # cache): a kernel measured for one input shape guides the planner
        # on the next shape's compile.  Created lazily — most functions
        # never turn autotuning on.
        self._measured_store = None
        self._last: Optional[_PlanEntry] = None
        self.num_compiles = 0
        self.num_fallbacks = 0
        # host seconds of the latest capture and lowering (the compile's
        # own are ``stats.compile_time_s``)
        self.capture_s = 0.0
        self.lower_s = 0.0
        functools.update_wrapper(self, fn)

    # -- static/dynamic argument split ------------------------------------
    def _resolve_nums(self, nums: Tuple[int, ...], n: int, label: str) -> set:
        out = set()
        for i in nums:
            j = i + n if i < 0 else i
            if not 0 <= j < n:
                raise ValueError(
                    f"{label} index {i} is out of range for a call with "
                    f"{n} positional argument(s)"
                )
            out.add(j)
        return out

    def _split(self, args, kwargs):
        """(statics_key, static_positions, dyn_args, dyn_kwargs)."""
        n = len(args)
        static_pos = (self._resolve_nums(self.static_argnums, n, "static_argnums")
                      if self.static_argnums else set())
        static_names = set(self.static_argnames) & set(kwargs)
        statics = tuple(
            [(j, args[j]) for j in sorted(static_pos)]
            + [(k, kwargs[k]) for k in sorted(static_names)]
        )
        try:
            hash(statics)
        except TypeError as e:
            bad = [f"{tag}={type(v).__name__}" for tag, v in statics if not _hashable(v)]
            raise TypeError(
                "Non-hashable static arguments are not supported: " + ", ".join(bad)
            ) from e
        dyn_args = tuple(a for i, a in enumerate(args) if i not in static_pos)
        dyn_kwargs = {k: v for k, v in kwargs.items() if k not in static_names}
        return statics, static_pos, dyn_args, dyn_kwargs

    def _donated_param_names(self, n_args: int, static_pos: set, dyn_args,
                             tensor_leaves: Tuple[int, ...]) -> Optional[frozenset]:
        """The parameter names covered by ``donate_argnums``.  Parameters
        are named ``arg{k}`` over the tensor leaves of the flattened
        ``(dyn_args, dyn_kwargs)``, positional leaves first — so
        per-argument leaf counts locate each donated argument's names."""
        if not self.donate_argnums:
            return None
        donated = self._resolve_nums(self.donate_argnums, n_args, "donate_argnums")
        if donated & static_pos:
            raise ValueError(
                f"donate_argnums resolve onto static arguments: {sorted(donated & static_pos)}"
            )
        param_of = {leaf: f"arg{k}" for k, leaf in enumerate(tensor_leaves)}
        dyn_positions = [i for i in range(n_args) if i not in static_pos]
        names: List[str] = []
        off = 0
        for dyn_idx, orig in enumerate(dyn_positions):
            cnt = len(pytree.tree_leaves(dyn_args[dyn_idx]))
            if orig in donated:
                names.extend(param_of[off + k] for k in range(cnt) if off + k in param_of)
            off += cnt
        return frozenset(names) if names else None

    # -- plan cache -------------------------------------------------------
    def _signature(self, args, kwargs):
        statics, static_pos, dyn_args, dyn_kwargs = self._split(args, kwargs)
        leaves, spec = pytree.tree_flatten((dyn_args, dyn_kwargs))
        key = (statics, spec, tuple(_leaf_key(leaf) for leaf in leaves))
        return key, leaves, spec, static_pos, dyn_args, len(args)

    def _bind_statics(self, args, kwargs, static_pos) -> Callable:
        """``fn`` over the dynamic arguments, the static values closed over
        (compile-time constants of the capture; a new static value is a new
        plan-cache key)."""
        n = len(args)
        static_vals = {i: args[i] for i in static_pos}
        static_kw = {k: kwargs[k] for k in self.static_argnames if k in kwargs}
        fn = self._fn

        def inner(*dyn, **dyn_kw):
            it = iter(dyn)
            full = [static_vals[i] if i in static_vals else next(it) for i in range(n)]
            kw = dict(static_kw)
            kw.update(dyn_kw)
            return fn(*full, **kw)

        return inner

    def _get_measured_store(self):
        if self._measured_store is None and (
            self.options.autotune or self.options.tuning_store_path
        ):
            from ..core.measure import MeasuredCostStore, device_fingerprint
            from ..core.pipeline import resolve_options

            # keyed as compile_module keys its own store: the spec the
            # compile plans with and this function's device
            dev = resolve_device(self.device)
            self._measured_store = MeasuredCostStore(
                self.options.tuning_store_path,
                device_fp=device_fingerprint(resolve_options(self.options, dev).device_spec, dev),
            )
        return self._measured_store

    def _lower(self, args, kwargs, static_pos, leaves, spec) -> Tuple[LoweredGraph, Any, Tuple[int, ...]]:
        if self.mesh is not None:
            return self._lower_sharded(args, kwargs, leaves, spec)
        with tracing.span("capture") as cap:
            gm, out_spec = capture(self._bind_statics(args, kwargs, static_pos), leaves, spec)
        tensor_leaves = tuple(i for i, leaf in enumerate(leaves) if _is_tensor_leaf(leaf))
        with tracing.span("lower") as low:
            lowered = lower_graph(gm, name=self.name, fuse_dot=self.options.fuse_dot)
        self.capture_s, self.lower_s = cap.seconds, low.seconds
        return lowered, out_spec, tensor_leaves

    def _lower_sharded(self, args, kwargs, leaves, spec):
        """Capture ``fn`` at the local shapes ``in_specs`` cut from the
        global arguments, and lower it with its placement."""
        if kwargs or len(args) != len(self.in_specs) or len(leaves) != len(args) \
                or not all(_is_tensor_leaf(a) for a in leaves):
            raise ValueError(
                f"stitch(mesh=...) takes {len(self.in_specs)} positional tensor "
                f"argument(s), one per in_spec"
            )
        sizes = mesh_sizes(self.mesh)
        in_layouts, local = [], []
        for k, (leaf, sp) in enumerate(zip(leaves, self.in_specs, strict=True)):
            t = _as_tensor(leaf)
            lay = spec_to_layout(sp, t.ndim)
            shape = list(t.shape)
            for d, e in enumerate(lay):
                n = 1
                for a in e or ():
                    n *= sizes[a]
                if shape[d] % n:
                    raise ValueError(
                        f"argument {k}: dim {d} of size {shape[d]} does not split {n} ways "
                        f"over {e}"
                    )
                shape[d] //= n
            in_layouts.append(lay)
            local.append(torch.empty(shape, dtype=t.dtype, device="meta"))
        with tracing.span("capture") as cap:
            gm, out_spec = capture(self._fn, local, spec)
        with tracing.span("lower") as low:
            outs = [n for n in gm.graph.nodes if n.op == "output"][0].args[0]
            ranks = [len(o.meta["val"].shape) for o in outs]
            specs = [self.out_specs] if out_spec.is_leaf() else list(self.out_specs)
            if len(specs) != len(ranks):
                raise ValueError(f"{len(specs)} out_specs for {len(ranks)} outputs")
            lowered = lower_sharded_graph(
                gm, self.mesh, in_layouts, [spec_to_layout(sp, r) for sp, r in zip(specs, ranks)],
                name=self.name, fuse_dot=self.options.fuse_dot,
            )
        self.capture_s, self.lower_s = cap.seconds, low.seconds
        return lowered, out_spec, tuple(range(len(leaves)))

    def _compile_lowered(self, lowered: LoweredGraph,
                         donate_params: Optional[frozenset]) -> CompiledModule:
        sharded = self.mesh is not None
        return compile_module(
            lowered.module, self.options, kernel_cache=self._kernel_cache,
            device=self.device, measured_store=self._get_measured_store(),
            donate_params=donate_params,
            mesh=self.mesh if sharded else None,
            param_layouts=lowered.param_layouts if sharded else None,
            out_layouts=lowered.out_layouts if sharded else None,
        )

    def _run_eager(self, args, kwargs):
        """The fallback: ``fn`` run eagerly as plain PyTorch on the plan's
        device, its tensor and numpy arguments moved there; under a mesh,
        on each rank's blocks, its outputs gathered (``wrap_shard_map``)."""
        dev = resolve_device(self.device)

        def place(leaf):
            return _as_tensor(leaf).to(dev) if _is_tensor_leaf(leaf) else leaf

        args, kwargs = pytree.tree_map(place, (args, kwargs))
        if self.mesh is not None:
            return wrap_shard_map(self._fn, self.mesh, self.in_specs, self.out_specs)(*args)
        return self._fn(*args, **kwargs)

    def _compile(self, key, args, kwargs, static_pos, leaves, spec, dyn_args, n_args) -> _PlanEntry:
        try:
            lowered, out_spec, tensor_leaves = self._lower(args, kwargs, static_pos, leaves, spec)
        except UnsupportedPrimitiveError:
            if self.on_unsupported != "fallback":
                raise
            self.num_fallbacks += 1
            entry = _PlanEntry(None, None, None)
            self._plans[key] = entry
            return entry
        compiled = self._compile_lowered(
            lowered, self._donated_param_names(n_args, static_pos, dyn_args, tensor_leaves)
        )
        self.num_compiles += 1
        entry = _PlanEntry(lowered, compiled, out_spec, tensor_leaves)
        self._plans[key] = entry
        self._last = entry
        return entry

    # -- the jit-shaped surface -------------------------------------------
    def __call__(self, *args, **kwargs):
        with tracing.span("call"):
            key, leaves, spec, static_pos, dyn_args, n_args = self._signature(args, kwargs)
            entry = self._plans.get(key)
            if entry is None:
                with tracing.span("compile", function=self.name, arguments=len(args)) as sp:
                    entry = self._compile(key, args, kwargs, static_pos, leaves, spec,
                                          dyn_args, n_args)
                    if entry.compiled is not None:
                        sp.attrs["kernels"] = [k.fn.symbol
                                               for k in entry.compiled.launched_kernels]
            if entry.is_fallback:
                return self._run_eager(args, kwargs)
            feeds = {
                name: leaves[i]
                for name, i in zip(entry.lowered.param_names, entry.tensor_leaves, strict=True)
            }
            out = entry.compiled(feeds)
            flat = [out[n] for n in entry.lowered.output_names]
            return pytree.tree_unflatten(flat, entry.out_spec)

    def lower(self, *args, **kwargs) -> Lowered:
        """A ``Lowered`` introspection handle (``jax.jit(...).lower()``
        analogue): ``.module`` / ``.as_text()`` inspect the captured
        StitchIR without compiling; ``.num_kernels`` / ``.cost_estimate()``
        compile lazily on first use.

        With arguments (tensors, arrays, or ``torch.empty(..., device=
        "meta")`` shape carriers): capture + lower for those shapes.
        Without arguments: the most recent compiled call.
        """
        if args or kwargs:
            key, leaves, spec, static_pos, dyn_args, n_args = self._signature(args, kwargs)
            entry = self._plans.get(key)
            if entry is not None and not entry.is_fallback:
                return Lowered(entry.lowered, lambda: entry.compiled, compiled=entry.compiled)
            lowered, _, tensor_leaves = self._lower(args, kwargs, static_pos, leaves, spec)
            donate = self._donated_param_names(n_args, static_pos, dyn_args, tensor_leaves)
            return Lowered(lowered, lambda: self._compile_lowered(lowered, donate))
        if self._last is None:
            raise ValueError(
                f"{self.name} has not been compiled yet — call it (or pass "
                "example arguments to .lower())"
            )
        entry = self._last
        return Lowered(entry.lowered, lambda: entry.compiled, compiled=entry.compiled)

    @property
    def stats(self) -> CompileStats:
        """CompileStats of the most recent compile."""
        if self._last is None:
            if self.num_fallbacks:
                raise ValueError(
                    f"{self.name} has no compile stats: all {self.num_fallbacks} "
                    "signature(s) fell back to plain PyTorch (on_unsupported="
                    "'fallback'), so nothing was captured into StitchIR"
                )
            raise ValueError(f"{self.name} has not been compiled yet — call it first")
        return self._last.compiled.stats

    def report(self) -> str:
        """Human-readable summary of the most recent compile."""
        s = self.stats
        m = self._last.lowered.module
        lines = [
            f"stitched function {self.name}: "
            f"{len(m.instructions)} StitchIR instructions, {len(m.parameters)} parameters",
            f"  stitched kernels : {s.stitched_kernels}",
            f"  standalone       : {s.standalone_kernels}",
            f"  library calls    : {s.library_calls}",
            f"  XLA baseline     : {s.xla_baseline_kernels} kernels "
            f"(fusion ratio {s.fusion_ratio:.3f})",
            f"  plan cache       : {len(self._plans)} signature(s), "
            f"{self.num_compiles} compile(s), {self.num_fallbacks} fallback(s)",
        ]
        if s.loop_calls:
            lines.insert(
                5,
                f"  loop calls       : {s.loop_calls} site(s), {s.sub_compiles} unique "
                f"body(ies), {s.sub_kernels} body kernel(s)",
            )
        for r in s.reports:
            lines.append(
                f"    kernel {r.name}: {r.num_ops} ops, {r.blocks} blocks, "
                f"{r.scratch_bytes}B scratch, roots={r.roots}"
            )
        return "\n".join(lines)

    def __repr__(self):
        return (
            f"StitchedFunction({self.name}, planner={self.options.planner!r}, "
            f"{len(self._plans)} cached plan(s))"
        )


def stitch(
    fn: Optional[Callable] = None,
    *,
    options: Optional[StitchOptions] = None,
    on_unsupported: str = "error",
    name: Optional[str] = None,
    autotune: Optional[bool] = None,
    static_argnums: Union[int, Sequence[int], None] = (),
    static_argnames: Union[str, Sequence[str], None] = (),
    donate_argnums: Union[int, Sequence[int], None] = (),
    device=None,
    mesh=None,
    in_specs=None,
    out_specs=None,
) -> StitchedFunction:
    """Capture a PyTorch function into StitchIR and compile it per input
    signature, on ``device``: the card unless the caller asks for the CPU.

    Usable directly (``stitched = stitch(fn)``) or as a decorator, bare or
    parameterized::

        @stitch
        def f(x): ...

        @stitch(options=StitchOptions(planner="greedy"), device="cpu")
        def g(x): ...

    ``on_unsupported``: ``"error"`` (default) raises
    ``UnsupportedPrimitiveError`` when the function uses an op outside the
    supported set; ``"fallback"`` runs the whole function eagerly as plain
    PyTorch on the same device instead (counted in ``num_fallbacks``).

    ``static_argnums`` / ``static_argnames`` mirror ``jax.jit``: the named
    arguments are compile-time constants, keyed by value into the plan
    cache (values must be hashable).  A Python number passed as a dynamic
    argument is baked into the capture too, and so keys the cache by its
    value.  ``donate_argnums`` marks positional arguments whose buffers the
    caller gives up.

    ``autotune``: convenience override of ``options.autotune``.

    ``mesh``/``in_specs``/``out_specs`` give the sharded form (module
    docstring): ``fn`` is the per-shard body, every rank calls with global
    arguments and gets global outputs back.
    """
    if fn is None:
        return functools.partial(
            stitch, options=options, on_unsupported=on_unsupported, name=name,
            autotune=autotune, static_argnums=static_argnums,
            static_argnames=static_argnames, donate_argnums=donate_argnums,
            device=device, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
        )
    if autotune is not None:
        options = dataclasses.replace(
            options if options is not None else StitchOptions(), autotune=autotune
        )
    return StitchedFunction(
        fn, options=options, on_unsupported=on_unsupported, name=name,
        static_argnums=static_argnums, static_argnames=static_argnames,
        donate_argnums=donate_argnums, device=device, mesh=mesh,
        in_specs=in_specs, out_specs=out_specs,
    )
