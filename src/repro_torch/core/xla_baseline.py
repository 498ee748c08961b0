"""XLA ``GpuInstructionFusion``-like baseline — the paper's comparison point.

This is a faithful re-statement of XLA's classic static ``ShouldFuse`` rules
(the rules the paper says are "compromised by exceptions, such as expensive
elementwise ops, column reductions, batched matmuls, or memory layout
transposes"):

  * loop fusion only: a producer is absorbed into its consumers when it is an
    elementwise / shape-modulation op;
  * producers may be *duplicated* into several consumer kernels, but
    **expensive** elementwise ops are never duplicated (single-user only);
  * ``reduce`` may only be a fusion *root* (input fusion), never an interior
    node of a loop fusion;
  * ``dot`` is never fused (library call);
  * no horizontal (multi-output, intra-layer) fusion.

Kernel count = number of non-absorbed instructions.  FusionStitching's
fusion-ratio benchmark (paper Fig. 7) divides its kernel count by this one.
"""
from __future__ import annotations

from typing import Dict, List, Set

from .ir import Instruction, Module


def _constant_like(instr: Instruction) -> bool:
    if instr.opcode in ("constant", "iota"):
        return True
    if instr.opcode in ("broadcast", "reshape", "bitcast", "transpose"):
        return all(_constant_like(o) for o in instr.operands)
    return False

_ABSORBING = frozenset(
    {"elementwise", "select", "reshape", "bitcast", "transpose", "broadcast",
     "reduce", "concat"}
)
_LOOP_FUSIBLE = frozenset(
    {"elementwise", "select", "reshape", "bitcast", "transpose", "broadcast",
     "iota"}
)


def _can_absorb(user: Instruction) -> bool:
    return user.opcode in _ABSORBING


def xla_baseline_kernels(module: Module) -> List[Instruction]:
    """Kernel roots under the XLA-like rules (excluding params/constants)."""
    absorbed: Set[int] = set()
    for instr in module.instructions:
        if instr.opcode in ("parameter", "constant"):
            continue
        if instr.opcode not in _LOOP_FUSIBLE:
            continue  # reduce/dot/gather/concat are never interior
        if not instr.users:
            continue  # module output must materialize
        if instr.is_expensive and len(instr.users) > 1:
            continue  # XLA: never duplicate expensive ops
        if all(_can_absorb(u) for u in instr.users):
            absorbed.add(instr.id)
    return [
        i
        for i in module.instructions
        if i.id not in absorbed
        and i.opcode not in ("parameter", "constant")
        and not _constant_like(i)
    ]


def xla_baseline_kernel_count(module: Module, exclude_library: bool = True) -> int:
    """``get`` projections are free (they name one output of a loop call);
    a ``call`` loop counts as its body's baseline kernels — XLA compiles a
    ``while``/``scan`` body once into its own kernels (launched per
    iteration, but Fig. 7 compares kernel *counts*, not launches)."""
    total = 0
    for r in xla_baseline_kernels(module):
        if r.opcode == "get":
            continue
        if r.is_collective:
            continue  # ICI traffic in ANY compiler — never a kernel launch
        if r.opcode == "call":
            total += xla_baseline_kernel_count(
                r.attrs["body"], exclude_library
            )
            continue
        if exclude_library and r.is_library_call:
            continue
        total += 1
    return total


def xla_baseline_groups(module: Module) -> Dict[int, List[Instruction]]:
    """Kernel root id -> member closure (absorbed producers, duplicated)."""
    roots = xla_baseline_kernels(module)
    root_ids = {r.id for r in roots}
    groups: Dict[int, List[Instruction]] = {}
    for root in roots:
        members: List[Instruction] = []
        seen: Set[int] = set()
        stack = [root]
        while stack:
            cur = stack.pop()
            if cur.id in seen:
                continue
            seen.add(cur.id)
            members.append(cur)
            for op in cur.operands:
                if op.id not in root_ids and op.opcode not in (
                    "parameter",
                    "constant",
                ):
                    # op was absorbed (into possibly several kernels)
                    stack.append(op)
        groups[root.id] = members
    return groups
