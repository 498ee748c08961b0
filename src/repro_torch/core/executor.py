"""Executors for the port: the torch reference oracle and the planned runtime.

``reference_execute`` walks the module with ``apply_op`` — one torch op per
instruction, the oracle every generated kernel is held against and the
unfused yardstick on the card.

``StitchedExecutable`` runs a compile-time ``ExecutionPlan`` as the
reference does (``repro/core/executor.py``): constant-like chains are
folded once at plan-build time, every value that flows between execution
units lives in a flat buffer table released at its last read, and each step
is pre-bound to its kernel, instruction or loop and its slots.

Two replays of one plan, as the reference has two:

  * ``execute``, the eager loop: one launch per stitched kernel, one torch
    op per standalone instruction, one ``torch.matmul`` per library dot, and
    a loop (``_LoopStep``) runs its compiled body ``trip_count`` times.  It
    is the CPU's path and the oracle of the other.
  * ``replay``, the port's ``jit_execute``: on the card the same step loop
    is captured once into a ``torch.cuda.CUDAGraph`` (after one warm-up run
    on a side stream, which makes every launcher's one-time occupancy query
    and ``cudaFuncSetAttribute`` happen outside the capture) and replayed,
    so a call costs one graph launch plus the copies: the feeds into the
    graph's static input buffers, and the roots the graph produced out of
    the graph's pool, so results the caller holds stay valid after the next
    call (the small tensors' copies batched by dtype, ``_copy_groups``).
    A loop is captured ``trip_count`` times over, the counterpart of the
    reference's scan inside ``jit``.  Every step captures: generated
    kernels (the stitched kernel's cooperative launch included), library
    dots, standalone ops and loops, so the whole plan is one graph.  A
    capture that fails raises, naming its step, and never falls back to
    the eager loop.

Which one a call takes is fixed when the plan is built
(``StitchedExecutable.replay_mode``): the replay on the card with
``jit_replay``, unless it would dispatch more than the eager loop
(``traced_dispatches_per_call > eager_dispatches_per_call``, a plan of one
kernel with its feed and root copies), which then runs eager.

A plan compiled with a ``mesh`` is sharded (``replay_mode == "sharded"``).
The reference traces its step loop once under ``shard_map`` and one
controller runs it on every device.  The port is SPMD: every rank of a
``torch.distributed`` world runs the same per-shard plan in its own
process, through the eager loop, and a collective step calls
``torch.distributed`` on the process group of its mesh axes
(``core/comm.py``), group and form fixed when the plan is built.  Feeds
and results are global, as in the reference: ``sharded_execute`` cuts each
rank's block of a global feed by the rank's mesh coordinate and the
parameter's layout, and all-gathers each sharded output once after the plan
(``LaunchStats.assembly_gathers``, counted apart from the plan's
collectives: the reference's ``out_specs`` assemble it for free).  There is
no CUDA-graph capture of a sharded plan.

Launch counters tick in the Python wrapper that launches a kernel, and a
replay runs no wrapper: the plan undoes the ticks of its capture, records
them, and adds them to each kernel's counter at every replay.  Those
replay counts are bookkeeping; on the card ``chip_smoke.py`` holds them
against the device kernels ``torch.profiler`` sees in a replayed call.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import tracing
from . import comm
from .codegen import KernelProgram, StitchedKernel
from .device import resolve_device
from .fusion import FusionPlan, constant_like
from .ir import Instruction, Module, apply_op, as_dtype, torch_dtype
from .shard import block_cuts, local_block

def as_feed(value, dtype, device) -> torch.Tensor:
    """A feed (numpy array or tensor) as a tensor of the parameter's dtype
    on ``device`` — the port's ``jnp.asarray(value, dtype)``.  A numpy
    bfloat16 array (ml_dtypes', which torch cannot read) goes across by
    its bits."""
    if isinstance(value, np.ndarray) and value.dtype.name == "bfloat16":
        value = torch.from_numpy(value.view(np.int16)).view(torch.bfloat16)
    return torch.as_tensor(value, dtype=torch_dtype(dtype), device=device)


def reference_execute(module: Module, feeds: Dict[str, object], device=None) -> Dict[str, torch.Tensor]:
    """Run ``module`` one torch op per instruction on ``device`` (the card
    unless the caller asks for the CPU); outputs keyed by root name."""
    device = resolve_device(device)
    vals: Dict[int, torch.Tensor] = {}
    for instr in module.instructions:
        if instr.opcode == "parameter":
            if instr.name not in feeds:
                raise KeyError(f"missing feed for parameter {instr.name}")
            v = as_feed(feeds[instr.name], instr.dtype, device)
            if tuple(v.shape) != tuple(instr.shape):
                raise ValueError(f"{instr.name}: feed shape {tuple(v.shape)} != {instr.shape}")
            vals[instr.id] = v
        else:
            vals[instr.id] = apply_op(
                instr, *[vals[o.id] for o in instr.operands], device=device
            )
    return {r.name: vals[r.id] for r in module.roots}


@dataclass
class LaunchStats:
    stitched_kernels: int = 0
    standalone_kernels: int = 0
    library_calls: int = 0
    loop_calls: int = 0                  # sub-module loops (``call`` instructions)
    traced_calls: int = 0                # calls through the CUDA-graph replay
    eager_calls: int = 0                 # calls through the eager step loop
    graph_captures: int = 0              # CUDA graphs captured so far
    eager_dispatches_per_call: int = 0   # launches and torch ops the eager loop makes
    # what one replayed call dispatches: the graph's launch, the copies of
    # the feeds into its static inputs and of the roots out of its pool
    # (one dispatch a group of ``_copy_groups``)
    traced_dispatches_per_call: int = 0
    donated_buffers: int = 0             # donated parameters whose buffer a later kernel writes
    collective_calls: int = 0            # collective steps a call runs (wire traffic, not launches)
    assembly_gathers: int = 0            # gathers a sharded call makes to return global outputs


def order_units(plan: FusionPlan) -> List[object]:
    """Topological order over execution units (fusions + standalone).

    Fusion groups interleave in instruction order, so units are ordered by
    their value dependences (fusion-time cycle checks make the group graph
    a DAG)."""
    units: List[object] = list(plan.fusions) + list(plan.standalone)
    unit_of: Dict[int, int] = {}
    for ui, u in enumerate(units):
        members = [u] if isinstance(u, Instruction) else u.members
        for m in members:
            unit_of[m.id] = ui
    deps: List[set] = [set() for _ in units]
    for ui, u in enumerate(units):
        srcs = u.operands if isinstance(u, Instruction) else u.inputs
        for s in srcs:
            if s.id in unit_of and unit_of[s.id] != ui:
                deps[ui].add(unit_of[s.id])
    indeg = [len(d) for d in deps]
    rdeps: List[set] = [set() for _ in units]
    for ui, d in enumerate(deps):
        for v in d:
            rdeps[v].add(ui)
    ready = deque(sorted(ui for ui, k in enumerate(indeg) if k == 0))
    order = []
    while ready:
        ui = ready.popleft()
        order.append(ui)
        for v in sorted(rdeps[ui]):
            indeg[v] -= 1
            if indeg[v] == 0:
                ready.append(v)
    if len(order) != len(units):
        raise RuntimeError("cyclic fusion plan — fusion cycle check failed")
    return [units[ui] for ui in order]


class _KernelStep:
    """One stitched-kernel launch, pre-bound to its buffer slots."""

    __slots__ = ("kernel", "arg_slots", "out_slots", "release", "reuse")

    def __init__(self, kernel: StitchedKernel, arg_slots, out_slots):
        self.kernel = kernel
        self.arg_slots = arg_slots
        self.out_slots = out_slots
        self.release: List[int] = []
        # per output, the donated parameter slot whose buffer it is written
        # into (None: a fresh buffer); empty where no output takes one
        self.reuse: List[Optional[int]] = []


class _OpStep:
    """One standalone instruction (library dot, collective etc.),
    pre-bound.  A collective of a sharded plan carries its process group
    and form (``comm``), fixed when the plan is built."""

    __slots__ = ("instr", "arg_slots", "out_slot", "release", "comm")

    def __init__(self, instr: Instruction, arg_slots, out_slot):
        self.instr = instr
        self.arg_slots = arg_slots
        self.out_slot = out_slot
        self.release: List[int] = []
        self.comm: Optional[Tuple[object, str]] = None


class _LoopStep:
    """One sub-module loop (``call`` instruction), pre-bound.

    The body is a separately compiled ``ExecutionPlan`` (``SubModulePass``)
    whose step loop runs once per iteration, carries threaded, the
    iteration's xs sliced off their leading dim and its ys stacked, in
    reverse where the loop says so.  The eager replay runs it ``trip``
    times; a CUDA-graph capture records those same ``trip`` runs of the
    body's kernels, in order, so the replayed loop costs no dispatch of its
    own."""

    __slots__ = (
        "instr", "body_plan", "arg_slots", "out_slots", "out_indices",
        "release", "num_consts", "num_carry", "trip", "reverse",
        "out_order", "out_shapes", "out_dtypes",
    )

    def __init__(self, instr: Instruction, body_plan: "ExecutionPlan", arg_slots,
                 out_slots, out_indices):
        a = instr.attrs
        self.instr = instr
        self.body_plan = body_plan
        self.arg_slots = arg_slots
        self.out_slots = out_slots             # one per live ``get`` projection
        self.out_indices = list(out_indices)   # logical output index per slot
        self.release: List[int] = []
        self.num_consts = int(a["num_consts"])
        self.num_carry = int(a["num_carry"])
        self.trip = int(a["trip_count"])
        self.reverse = bool(a.get("reverse", False))
        self.out_order = list(a["out_order"])
        self.out_shapes = [tuple(s) for s in a["out_shapes"]]
        self.out_dtypes = [as_dtype(d) for d in a["out_dtypes"]]

    @property
    def dispatches(self) -> int:
        """Launches and torch ops one eager run of the loop makes."""
        return self.trip * self.body_plan.stats.eager_dispatches_per_call

    def run(self, args: Sequence[torch.Tensor], device) -> List[torch.Tensor]:
        nc, k = self.num_consts, self.num_carry
        consts = list(args[:nc])
        carry = list(args[nc:nc + k])
        xs = list(args[nc + k:])
        n_y = len(self.out_order) - k
        cols: List[List[torch.Tensor]] = [[] for _ in range(n_y)]
        steps = range(self.trip - 1, -1, -1) if self.reverse else range(self.trip)
        for t in steps:
            roots = self.body_plan.run_positional(consts + carry + [x[t] for x in xs])
            ordered = [roots[j] for j in self.out_order]
            carry = ordered[:k]
            for j in range(n_y):
                cols[j].append(ordered[k + j])
        if self.reverse:
            cols = [list(reversed(c)) for c in cols]
        ys = [
            torch.stack(c) if c else torch.zeros(
                self.out_shapes[k + j], dtype=torch_dtype(self.out_dtypes[k + j]), device=device)
            for j, c in enumerate(cols)
        ]
        all_outs = carry + ys
        return [all_outs[i] for i in self.out_indices]


def _step_outs(step) -> List[int]:
    if type(step) is _OpStep:
        return [step.out_slot]
    return step.out_slots


def _step_name(step) -> str:
    if type(step) is _KernelStep:
        return f"kernel {step.kernel.fn.name} ({step.kernel.fusion.name})"
    if type(step) is _LoopStep:
        return f"loop {step.instr.name}"
    return f"{step.instr.opcode} {step.instr.name}"


def _step_dispatches(step) -> int:
    return step.dispatches if type(step) is _LoopStep else 1


def _programs(steps) -> List[KernelProgram]:
    """Every generated kernel the steps launch, loop bodies included."""
    out: Dict[int, KernelProgram] = {}
    for step in steps:
        if type(step) is _KernelStep:
            out[id(step.kernel.fn)] = step.kernel.fn
        elif type(step) is _LoopStep:
            for prog in _programs(step.body_plan.steps):
                out[id(prog)] = prog
    return list(out.values())


#: tensors of more elements than this take a copy of their own: the
#: batched copy gives each 65,536 elements one block, too few blocks for a
#: large tensor (StitchPipe's 655 KB feed took 8 µs so)
BATCHED_COPY_ELEMENTS = 65_536


def _copy_groups(values: Sequence[Instruction]) -> List[List[int]]:
    """How the replay copies these values (its feeds in, or its roots out),
    as groups of their indices, one dispatch each: every value of more than
    ``BATCHED_COPY_ELEMENTS`` elements alone, the small ones one group per
    dtype (one ``_foreach_copy_``: a list of mixed dtypes takes its slow
    path, a copy at a time)."""
    groups: Dict[object, List[int]] = {}
    for i, v in enumerate(values):
        key = i if v.num_elements > BATCHED_COPY_ELEMENTS else np.dtype(v.dtype)
        groups.setdefault(key, []).append(i)
    return list(groups.values())


def _copy_all(dst: Sequence[torch.Tensor], src: Sequence[torch.Tensor],
              groups: List[List[int]]) -> None:
    """``dst[i].copy_(src[i])`` for every index, one dispatch a group."""
    for g in groups:
        if len(g) == 1:
            dst[g[0]].copy_(src[g[0]])
        else:
            torch._foreach_copy_([dst[i] for i in g], [src[i] for i in g])


def _need_card(device) -> torch.device:
    dev = torch.device(device)
    if dev.type != "cuda":
        raise RuntimeError(f"CUDA-graph replay runs on the card, not on {dev}")
    return dev


def _warm_up(fn: Callable[[], List[torch.Tensor]], device) -> None:
    """Run ``fn`` once on a side stream, ordered after the current stream's
    work and before its next, as a capture asks of its warm-up."""
    dev = _need_card(device)
    current = torch.cuda.current_stream(dev)
    side = torch.cuda.Stream(dev)
    side.wait_stream(current)
    with torch.cuda.stream(side):
        fn()
    current.wait_stream(side)


def _capture_graph(fn: Callable[[], List[torch.Tensor]], device,
                   keep_graph: bool = False) -> Tuple[object, List[torch.Tensor]]:
    """Capture ``fn``'s launches on ``device`` into a ``torch.cuda.CUDAGraph``;
    returns the graph and what ``fn`` returned, the graph's static outputs.
    With ``keep_graph`` the graph is not instantiated at the capture's end:
    the caller calls its ``instantiate()`` (and can time it apart)."""
    _need_card(device)
    graph = torch.cuda.CUDAGraph(keep_graph=True) if keep_graph else torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = fn()
    return graph, outs


class _Graph:
    """A plan's pre-bound steps captured into one CUDA graph.

    ``feed_slots`` are the slots the steps read but neither produce nor
    find in the plan's template, i.e. the parameters they read: each call
    copies them into ``static_in``, the buffers the graph reads.  Template
    slots (folded constants) live as long as the plan, so the graph reads
    them where they are.  ``out_slots`` are the roots the steps produce;
    the graph writes them to ``static_out``, in its private memory pool.
    ``pool_released`` are the slots whose memory goes back to that pool at
    their release inside the capture, for later steps to reuse: the ones
    the steps produced.  A parameter's static input and a template tensor
    are held outside the pool and never go back to it.  ``in_groups`` and
    ``out_groups`` are the ``_copy_groups`` of the feeds and the roots;
    ``copy_bytes`` the bytes of both, which every replay copies."""

    __slots__ = ("steps", "feed_slots", "out_slots", "pool_released", "in_groups",
                 "out_groups", "copy_bytes", "graph", "static_in", "static_out", "ticks")

    def __init__(self, steps: List[object], roots: set, template_slots: set):
        self.steps = list(steps)
        produced: set = set()
        feeds: List[int] = []
        released: set = set()
        for step in self.steps:
            for s in step.arg_slots:
                if s not in produced and s not in template_slots and s not in feeds:
                    feeds.append(s)
            produced.update(_step_outs(step))
            released.update(step.release)
        self.feed_slots = feeds
        self.out_slots = sorted(s for s in produced if s in roots)
        self.pool_released = released & produced
        self.in_groups: List[List[int]] = []
        self.out_groups: List[List[int]] = []
        self.copy_bytes = 0
        self.graph = None
        self.static_in: List[torch.Tensor] = []
        self.static_out: List[torch.Tensor] = []
        self.ticks: List[Tuple[KernelProgram, int]] = []   # launches one replay makes


class ExecutionPlan:
    """Precomputed run recipe for a compiled FusionPlan on one device.

    Built once at compile time:
      * constant-like chains are evaluated here, on the plan's device,
        once — they never recur at call time;
      * a flat buffer table holds every inter-unit value; slots are released
        (set to None) right after their last consuming step;
      * each step carries its kernel/instruction/loop and operand slots;
      * ``_graph`` holds what the CUDA-graph replay needs of the steps.
    """

    def __init__(self, module: Module, plan: FusionPlan,
                 kernels: Dict[str, StitchedKernel], device, donate_params=None, mesh=None):
        self.device = torch.device(device)
        member_ids = {m.id for f in plan.fusions for m in f.members}
        covered = member_ids | {s.id for s in plan.standalone}
        units = order_units(plan)

        needed: set = {r.id for r in module.roots}
        for u in units:
            if isinstance(u, Instruction):
                needed.update(o.id for o in u.operands)
            else:
                needed.update(i.id for i in kernels[u.name].inputs)

        slot_of: Dict[int, int] = {}

        def new_slot(instr_id: int) -> int:
            slot_of[instr_id] = len(slot_of)
            return slot_of[instr_id]

        # ---- parameters + compile-time constant folding -------------------
        folded_vals: Dict[int, torch.Tensor] = {}

        def fold(instr: Instruction):
            if instr.id in folded_vals:
                return folded_vals[instr.id]
            v = apply_op(instr, *[fold(o) for o in instr.operands], device=self.device)
            folded_vals[instr.id] = v
            return v

        self._param_binds: List[Tuple[str, int, object, Tuple[int, ...]]] = []
        template_fill: List[Tuple[int, torch.Tensor]] = []
        for instr in module.instructions:
            if instr.opcode == "parameter":
                s = new_slot(instr.id)
                self._param_binds.append((instr.name, s, instr.dtype, tuple(instr.shape)))
            elif instr.id not in covered:
                if not (instr.opcode == "constant" or constant_like(instr)):
                    raise RuntimeError(f"{instr.name}: uncovered non-constant instruction")
                if instr.id in needed:
                    template_fill.append((new_slot(instr.id), fold(instr)))

        # ---- pre-bound steps in unit order ---------------------------------
        self.steps: List[object] = []
        for u in units:
            if isinstance(u, Instruction):
                if u.opcode == "get":
                    continue   # its slot is made by the call's loop step
                arg_slots = [slot_of[o.id] for o in u.operands]
                if u.opcode == "call":
                    gets = sorted((g for g in u.users if g.opcode == "get"),
                                  key=lambda g: g.attrs["index"])
                    if len(gets) != len(u.users):
                        raise RuntimeError(f"{u.name}: call outputs must be consumed "
                                           "through get projections")
                    cm = u.attrs.get("compiled_body")
                    if cm is None:
                        raise RuntimeError(f"{u.name}: loop body was not compiled — "
                                           "SubModulePass must run before plan construction")
                    self.steps.append(_LoopStep(
                        u, cm.executable.execution_plan, arg_slots,
                        [new_slot(g.id) for g in gets], [int(g.attrs["index"]) for g in gets],
                    ))
                else:
                    self.steps.append(_OpStep(u, arg_slots, new_slot(u.id)))
            else:
                k = kernels[u.name]
                arg_slots = [slot_of[i.id] for i in k.inputs]
                out_slots = [new_slot(r.id) for r in k.outputs]
                self.steps.append(_KernelStep(k, arg_slots, out_slots))

        # ---- collectives: each step's group and form, fixed here ------------
        #: (instruction, opcode, axes, backend, form) of every collective step
        self.collectives: List[Tuple[str, str, Tuple[str, ...], str, str]] = []
        if mesh is not None:
            for st in self.steps:
                if type(st) is _OpStep and st.instr.is_collective:
                    axes = tuple(st.instr.attrs["axes"])
                    group = comm.axis_group(mesh, axes)
                    form = comm.collective_form(st.instr.opcode, group, self.device)
                    st.comm = (group, form)
                    self.collectives.append((st.instr.name, st.instr.opcode, axes,
                                             comm.backend_of(group), form))

        self.num_slots = len(slot_of)
        # a feed already a tensor of its parameter's dtype on this device
        # binds as it is (``_bind_feeds``)
        self._param_tdtypes = [torch_dtype(dt) for _, _, dt, _ in self._param_binds]
        self._feed_device = self.device
        if self.device.type == "cuda" and self.device.index is None:
            self._feed_device = torch.device("cuda", torch.cuda.current_device())
        self._root_binds: List[Tuple[str, int]] = [
            (r.name, slot_of[r.id]) for r in module.roots
        ]

        # ---- eager-release points: free a slot after its last read ---------
        keep = {s for _, s in self._root_binds}
        last_read: Dict[int, int] = {}
        readers: Dict[int, List[object]] = {}
        for si, step in enumerate(self.steps):
            for s in step.arg_slots:
                last_read[s] = si
                readers.setdefault(s, []).append(step)

        # ---- donation: the eager loop writes a later kernel's output of a
        # donated parameter's shape and dtype into that parameter's buffer,
        # which the caller gave up (``donate_argnums``) and no later step
        # reads.  Only a parameter that kernels alone read qualifies: a
        # torch op or a loop may return a view of it that outlives its last
        # read.  ``donations`` maps each such parameter slot to the step
        # that takes its buffer, where the slot is then released.
        donate = frozenset(donate_params or ())
        self.donations: Dict[int, int] = {}
        taken: set = set()
        for name, p, dtype, shape in self._param_binds:
            if name not in donate or p in keep \
                    or any(type(st) is not _KernelStep for st in readers.get(p, ())):
                continue
            tdt = torch_dtype(dtype)
            for si in range(last_read.get(p, -1) + 1, len(self.steps)):
                st = self.steps[si]
                if type(st) is not _KernelStep:
                    continue
                j = next((j for j, r in enumerate(st.kernel.outputs)
                          if st.out_slots[j] not in taken and tuple(r.shape) == shape
                          and torch_dtype(r.dtype) == tdt), None)
                if j is not None:
                    st.reuse = st.reuse or [None] * len(st.out_slots)
                    st.reuse[j] = p
                    taken.add(st.out_slots[j])
                    self.donations[p] = si
                    break
        for s, si in last_read.items():
            if s not in keep and s not in self.donations:
                self.steps[si].release.append(s)
        for p, si in self.donations.items():
            self.steps[si].release.append(p)
        # dead outputs (a kernel root nothing reads) are released where made
        for step in self.steps:
            for s in _step_outs(step):
                if s not in keep and s not in last_read:
                    step.release.append(s)

        template: List[Optional[torch.Tensor]] = [None] * self.num_slots
        for s, v in template_fill:
            template[s] = v
        self._template = template

        # ---- the CUDA graph ---------------------------------------------------
        g = self._graph = _Graph(self.steps, keep, {s for s, _ in template_fill})
        instr_of = {slot_of[i.id]: i for i in list(module.parameters) + module.roots}
        g.in_groups = _copy_groups([instr_of[s] for s in g.feed_slots])
        g.out_groups = _copy_groups([instr_of[s] for s in g.out_slots])
        g.copy_bytes = sum(instr_of[s].num_elements * np.dtype(instr_of[s].dtype).itemsize
                           for s in g.feed_slots + g.out_slots)
        self.stats = LaunchStats(
            eager_dispatches_per_call=sum(_step_dispatches(st) for st in self.steps),
            traced_dispatches_per_call=1 + len(g.in_groups) + len(g.out_groups),
            loop_calls=sum(1 for st in self.steps if type(st) is _LoopStep),
            donated_buffers=len(self.donations),
            collective_calls=sum(1 for st in self.steps
                                 if type(st) is _OpStep and st.instr.is_collective),
        )

    # ------------------------------------------------------------- steps
    def _run_step(self, step, buf: List[Optional[torch.Tensor]], donated=frozenset()) -> None:
        """One pre-bound step on the buffer table, its releases included.
        ``donated`` holds the donated parameter slots whose buffers this
        call may write (``_writable_donations``)."""
        args = [buf[s] for s in step.arg_slots]
        if type(step) is _KernelStep:
            out = None
            if donated and step.reuse:
                out = [buf[p] if p in donated else None for p in step.reuse]
            outs = step.kernel(*args, device=self.device, out=out)
            for s, o in zip(step.out_slots, outs, strict=True):
                buf[s] = o
        elif type(step) is _LoopStep:
            for s, o in zip(step.out_slots, step.run(args, self.device), strict=True):
                buf[s] = o
        elif step.comm is not None:
            group, form = step.comm
            buf[step.out_slot] = comm.run_collective(step.instr, args[0], group, form)
        else:
            buf[step.out_slot] = apply_op(step.instr, *args, device=self.device)
        for s in step.release:
            buf[s] = None

    def run_positional(self, param_vals: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The whole step loop on parameter values given positionally (in
        ``_param_binds`` order, the call's operand order): a loop body's
        iteration.  Returns the roots in ``module.roots`` order."""
        buf = list(self._template)
        for (_, slot, _, _), v in zip(self._param_binds, param_vals, strict=True):
            buf[slot] = v
        for step in self.steps:
            self._run_step(step, buf)
        return [buf[s] for _, s in self._root_binds]

    def _bind_feeds(self, feeds: Dict[str, object]) -> List[torch.Tensor]:
        """Validated parameter tensors in ``_param_binds`` order."""
        vals = []
        for (name, slot, dtype, shape), tdt in zip(self._param_binds, self._param_tdtypes, strict=True):
            if name not in feeds:
                raise KeyError(f"missing feed for parameter {name}")
            v = feeds[name]
            if not (type(v) is torch.Tensor and v.dtype == tdt and v.device == self._feed_device):
                v = as_feed(v, dtype, self.device)
            if tuple(v.shape) != shape:
                raise ValueError(f"{name}: feed shape {tuple(v.shape)} != {shape}")
            vals.append(v)
        return vals

    def _fed_buffer(self, feeds) -> List[Optional[torch.Tensor]]:
        buf = list(self._template)
        for (_, slot, _, _), v in zip(self._param_binds, self._bind_feeds(feeds), strict=True):
            buf[slot] = v
        return buf

    def _writable_donations(self, buf: List[Optional[torch.Tensor]]) -> frozenset:
        """The donated parameter slots whose buffers this call may write: a
        contiguous tensor that needs no gradient and shares its storage with
        no other feed (one tensor passed twice is read through the other)."""
        feeds = [buf[s] for _, s, _, _ in self._param_binds]
        owners: Dict[int, int] = {}
        for t in feeds:
            k = t.untyped_storage().data_ptr()
            owners[k] = owners.get(k, 0) + 1
        return frozenset(
            p for p in self.donations
            if buf[p].is_contiguous() and not buf[p].requires_grad and buf[p].numel()
            and owners[buf[p].untyped_storage().data_ptr()] == 1
        )

    def execute(self, feeds: Dict[str, object]) -> Dict[str, torch.Tensor]:
        """Eager replay: one launch or torch op per pre-bound step, a loop's
        body once per iteration (the CPU's path, and the graph's oracle).
        A donated parameter's buffer takes the output planned for it
        (``donations``); the replay leaves feeds as they are, since it
        reads its own copies."""
        with tracing.span("execute", mode="eager"):
            buf = self._fed_buffer(feeds)
            donated = self._writable_donations(buf) if self.donations else frozenset()
            for step in self.steps:
                self._run_step(step, buf, donated)
            self.stats.eager_calls += 1
            return {name: buf[s] for name, s in self._root_binds}

    # ------------------------------------------------------------ replay
    def _capture(self, seg: _Graph, buf: List[Optional[torch.Tensor]]) -> None:
        """Warm the steps up on a side stream, then capture them."""
        seg.static_in = [buf[s].clone(memory_format=torch.contiguous_format) for s in seg.feed_slots]
        base = list(buf)
        for s, t in zip(seg.feed_slots, seg.static_in, strict=True):
            base[s] = t
        failed: List[object] = []

        def run() -> List[torch.Tensor]:
            work = list(base)
            for step in seg.steps:
                try:
                    self._run_step(step, work)
                except Exception:
                    failed.append(step)
                    raise
            return [work[s] for s in seg.out_slots]

        _warm_up(run, self.device)
        programs = _programs(seg.steps)
        before = [p.launches for p in programs]
        failed.clear()
        try:
            seg.graph, seg.static_out = _capture_graph(run, self.device)
        except Exception as e:
            where = _step_name(failed[0]) if failed else "the graph's end"
            raise RuntimeError(f"CUDA-graph capture failed at {where}: {e}") from e
        finally:
            ticks = [(p, p.launches - b) for p, b in zip(programs, before, strict=True)]
            for p, b in zip(programs, before, strict=True):
                p.launches = b      # a capture launches nothing
        seg.ticks = [(p, n) for p, n in ticks if n]
        self.stats.graph_captures += 1

    def replay(self, feeds: Dict[str, object]) -> Dict[str, torch.Tensor]:
        """CUDA-graph replay (module docstring): the first call captures
        the plan, every call replays it.  Equal, bit for bit, to
        ``execute`` wherever the kernels and torch ops are deterministic."""
        with tracing.span("execute", mode="graph"):
            buf = self._fed_buffer(feeds)
            g = self._graph
            if g.graph is None:
                with tracing.span("graph_capture"):
                    self._capture(g, buf)
            _copy_all(g.static_in, [buf[s] for s in g.feed_slots], g.in_groups)
            g.graph.replay()
            for p, n in g.ticks:
                p.launches += n
            self.stats.traced_calls += 1
            # the graph's outputs are overwritten by its next replay: the
            # roots it made are copied out of its pool
            copies = [torch.empty_like(t) for t in g.static_out]
            _copy_all(copies, g.static_out, g.out_groups)
            for s, t in zip(g.out_slots, copies, strict=True):
                buf[s] = t
            tracing.count("replay.calls", 1)
            tracing.count("replay.copy_bytes", g.copy_bytes)
            return {name: buf[s] for name, s in self._root_binds}


class StitchedExecutable:
    """Runs a compiled FusionPlan through its precomputed ExecutionPlan.

    ``jit_replay=True`` (the default) replays through a CUDA graph on the
    card where that dispatches no more than the eager loop
    (``replay_mode``); on the CPU, with ``jit_replay=False`` and for the
    other plans, every call takes the eager step loop, the oracle the
    replay is held against.  ``jit_execute`` replays whatever the mode.

    A ``mesh`` (a ``DeviceMesh``) makes this a sharded plan: every call,
    ``jit_execute`` and ``execute_eager`` included, is ``sharded_execute``
    on global feeds (module docstring)."""

    def __init__(self, module: Module, plan: FusionPlan,
                 kernels: Dict[str, StitchedKernel], device, jit_replay: bool = True,
                 donate_params=None, mesh=None, param_layouts=None, out_layouts=None):
        self.module = module
        self.plan = plan
        self.kernels = kernels
        self.mesh = mesh
        self.param_layouts = dict(param_layouts or {})
        self.out_layouts = list(out_layouts) if out_layouts else None
        self.execution_plan = ExecutionPlan(module, plan, kernels, device, donate_params,
                                            mesh=mesh)
        self.jit_replay = jit_replay
        if mesh is not None:
            self._build_sharded()

    @property
    def device(self) -> torch.device:
        return self.execution_plan.device

    @property
    def replay_mode(self) -> str:
        """``"sharded"`` for a plan with a mesh; else ``"graph"`` where
        calls replay the CUDA graph, or ``"eager"``: the graph on the card
        under ``jit_replay`` when a replayed call makes no more dispatches
        than an eager one.  At a tie the replay wins, as its dispatches are
        copies and one graph launch where the eager loop's are kernel
        wrappers and torch ops."""
        if self.mesh is not None:
            return "sharded"
        if not self.jit_replay or self.device.type != "cuda":
            return "eager"
        st = self.execution_plan.stats
        return "graph" if st.traced_dispatches_per_call <= st.eager_dispatches_per_call else "eager"

    # ----------------------------------------------------------- sharded
    def _build_sharded(self) -> None:
        """What a sharded call needs of the mesh, fixed once: this rank's
        block of each sharded parameter (``shard.block_cuts``) and, per
        root, the (dim, group, form) gathers that assemble it."""
        mesh = self.mesh
        self._blocks = {name: block_cuts(lay, mesh) for name, lay in self.param_layouts.items()}
        ep = self.execution_plan
        outs = self.out_layouts or [None] * len(ep._root_binds)
        self._assembly: List[List[Tuple[int, object, str]]] = []
        for lay in outs:
            gathers = []
            for d, e in enumerate(lay or ()):
                if e:
                    g = comm.axis_group(mesh, tuple(e))
                    gathers.append((d, g, comm.collective_form("all_gather", g, self.device)))
            self._assembly.append(gathers)
        ep.stats.assembly_gathers = sum(len(g) for g in self._assembly)

    def _global_shape(self, name: str, local: Tuple[int, ...]) -> Tuple[int, ...]:
        out = list(local)
        for d, _, n in self._blocks.get(name, ()):
            out[d] *= n
        return tuple(out)

    def sharded_execute(self, feeds: Dict[str, object]) -> Dict[str, torch.Tensor]:
        """One call of the sharded plan on this rank: global feeds in, this
        rank's blocks through the per-shard plan, global outputs back."""
        ep = self.execution_plan
        local: Dict[str, torch.Tensor] = {}
        for name, _, dtype, shape in ep._param_binds:
            if name not in feeds:
                raise KeyError(f"missing feed for parameter {name}")
            v = as_feed(feeds[name], dtype, self.device)
            want = self._global_shape(name, shape)
            if tuple(v.shape) != want:
                raise ValueError(
                    f"{name}: global feed shape {tuple(v.shape)} != {want} "
                    f"(per-shard {tuple(shape)})"
                )
            local[name] = local_block(v, self._blocks.get(name, ()))
        out = ep.execute(local)
        for (name, _), gathers in zip(ep._root_binds, self._assembly, strict=True):
            for d, group, form in gathers:
                out[name] = comm.all_gather(out[name], d, group, form)
        return out

    def launch_stats(self) -> LaunchStats:
        rt = self.execution_plan.stats
        return LaunchStats(
            stitched_kernels=len(self.plan.fusions),
            standalone_kernels=sum(
                1 for s in self.plan.standalone
                if not s.is_library_call and not s.is_collective
                and s.opcode not in ("call", "get")
            ),
            library_calls=self.plan.num_library_calls,
            loop_calls=rt.loop_calls,
            traced_calls=rt.traced_calls,
            eager_calls=rt.eager_calls,
            graph_captures=rt.graph_captures,
            eager_dispatches_per_call=rt.eager_dispatches_per_call,
            traced_dispatches_per_call=rt.traced_dispatches_per_call,
            donated_buffers=rt.donated_buffers,
            collective_calls=rt.collective_calls,
            assembly_gathers=rt.assembly_gathers,
        )

    def execute_eager(self, feeds: Dict[str, object]) -> Dict[str, torch.Tensor]:
        if self.mesh is not None:
            return self.sharded_execute(feeds)
        return self.execution_plan.execute(feeds)

    def jit_execute(self, feeds: Dict[str, object]) -> Dict[str, torch.Tensor]:
        if self.mesh is not None:
            return self.sharded_execute(feeds)
        return self.execution_plan.replay(feeds)

    def __call__(self, feeds: Dict[str, object]) -> Dict[str, torch.Tensor]:
        mode = self.replay_mode
        if mode == "sharded":
            return self.sharded_execute(feeds)
        if mode == "graph":
            return self.execution_plan.replay(feeds)
        return self.execution_plan.execute(feeds)
