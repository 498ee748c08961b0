"""Executors for the port: the torch reference oracle and the planned runtime.

``reference_execute`` walks the module with ``apply_op`` — one torch op per
instruction, the oracle every generated kernel is held against and the
unfused yardstick on the card.

``StitchedExecutable`` runs a compile-time ``ExecutionPlan`` as the
reference does (``repro/core/executor.py``): constant-like chains are
folded once at plan-build time, every value that flows between execution
units lives in a flat buffer table released at its last read, and each step
is pre-bound to its kernel or instruction and its slots.  This slice
replays eagerly only: one launch per stitched kernel, one torch op per
standalone instruction and one ``torch.matmul`` per library dot.  The
jitted segment replay of the reference (``jit_execute``) becomes CUDA-graph
replay in a later slice, and loops (``_LoopStep``) come with ``call``/``get``.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .codegen import StitchedKernel
from .device import resolve_device
from .fusion import FusionPlan, constant_like
from .ir import LOOPS_ITEM, Instruction, Module, apply_op, torch_dtype


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
    eager_calls: int = 0                 # calls through the eager step loop
    eager_dispatches_per_call: int = 0   # pre-bound steps the eager loop runs


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

    __slots__ = ("kernel", "arg_slots", "out_slots", "release")

    def __init__(self, kernel: StitchedKernel, arg_slots, out_slots):
        self.kernel = kernel
        self.arg_slots = arg_slots
        self.out_slots = out_slots
        self.release: List[int] = []


class _OpStep:
    """One standalone instruction (library dot etc.), pre-bound."""

    __slots__ = ("instr", "arg_slots", "out_slot", "release")

    def __init__(self, instr: Instruction, arg_slots, out_slot):
        self.instr = instr
        self.arg_slots = arg_slots
        self.out_slot = out_slot
        self.release: List[int] = []


def _step_outs(step) -> List[int]:
    if type(step) is _OpStep:
        return [step.out_slot]
    return step.out_slots


class ExecutionPlan:
    """Precomputed run recipe for a compiled FusionPlan on one device.

    Built once at compile time:
      * constant-like chains are evaluated here, on the plan's device,
        once — they never recur at call time;
      * a flat buffer table holds every inter-unit value; slots are released
        (set to None) right after their last consuming step;
      * each step carries its kernel/instruction and operand slot indices.
    """

    def __init__(self, module: Module, plan: FusionPlan,
                 kernels: Dict[str, StitchedKernel], device):
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
                if u.opcode in ("call", "get"):
                    raise NotImplementedError(f"{u.name}: loops are ported by {LOOPS_ITEM}")
                arg_slots = [slot_of[o.id] for o in u.operands]
                self.steps.append(_OpStep(u, arg_slots, new_slot(u.id)))
            else:
                k = kernels[u.name]
                arg_slots = [slot_of[i.id] for i in k.inputs]
                out_slots = [new_slot(r.id) for r in k.outputs]
                self.steps.append(_KernelStep(k, arg_slots, out_slots))

        self.num_slots = len(slot_of)
        self._root_binds: List[Tuple[str, int]] = [
            (r.name, slot_of[r.id]) for r in module.roots
        ]

        # ---- eager-release points: free a slot after its last read ---------
        keep = {s for _, s in self._root_binds}
        last_read: Dict[int, int] = {}
        for si, step in enumerate(self.steps):
            for s in step.arg_slots:
                last_read[s] = si
        for s, si in last_read.items():
            if s not in keep:
                self.steps[si].release.append(s)
        # dead outputs (a kernel root nothing reads) are released where made
        for step in self.steps:
            for s in _step_outs(step):
                if s not in keep and s not in last_read:
                    step.release.append(s)

        template: List[Optional[torch.Tensor]] = [None] * self.num_slots
        for s, v in template_fill:
            template[s] = v
        self._template = template
        self.stats = LaunchStats(eager_dispatches_per_call=len(self.steps))

    def _bind_feeds(self, feeds: Dict[str, object]) -> List[torch.Tensor]:
        """Validated parameter tensors in ``_param_binds`` order."""
        vals = []
        for name, slot, dtype, shape in self._param_binds:
            if name not in feeds:
                raise KeyError(f"missing feed for parameter {name}")
            v = as_feed(feeds[name], dtype, self.device)
            if tuple(v.shape) != shape:
                raise ValueError(f"{name}: feed shape {tuple(v.shape)} != {shape}")
            vals.append(v)
        return vals

    def execute(self, feeds: Dict[str, object]) -> Dict[str, torch.Tensor]:
        """Eager replay: one launch or torch op per pre-bound step."""
        buf = list(self._template)
        for (name, slot, dtype, shape), v in zip(self._param_binds, self._bind_feeds(feeds), strict=True):
            buf[slot] = v
        for step in self.steps:
            if type(step) is _KernelStep:
                outs = step.kernel(*[buf[s] for s in step.arg_slots], device=self.device)
                for s, o in zip(step.out_slots, outs, strict=True):
                    buf[s] = o
            else:
                buf[step.out_slot] = apply_op(
                    step.instr, *[buf[s] for s in step.arg_slots], device=self.device
                )
            for s in step.release:
                buf[s] = None
        self.stats.eager_calls += 1
        return {name: buf[s] for name, s in self._root_binds}


class StitchedExecutable:
    """Runs a compiled FusionPlan through its precomputed ExecutionPlan."""

    def __init__(self, module: Module, plan: FusionPlan,
                 kernels: Dict[str, StitchedKernel], device):
        self.module = module
        self.plan = plan
        self.kernels = kernels
        self.execution_plan = ExecutionPlan(module, plan, kernels, device)

    @property
    def device(self) -> torch.device:
        return self.execution_plan.device

    def launch_stats(self) -> LaunchStats:
        rt = self.execution_plan.stats
        return LaunchStats(
            stitched_kernels=len(self.plan.fusions),
            standalone_kernels=sum(
                1 for s in self.plan.standalone
                if not s.is_library_call and not s.is_collective
            ),
            library_calls=self.plan.num_library_calls,
            eager_calls=rt.eager_calls,
            eager_dispatches_per_call=rt.eager_dispatches_per_call,
        )

    def __call__(self, feeds: Dict[str, object]) -> Dict[str, torch.Tensor]:
        return self.execution_plan.execute(feeds)
