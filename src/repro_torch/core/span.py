"""Work/Span (critical-path) analysis — paper §3.1.

Each instruction gets a *span*: the root (sink) instructions have span 0 and
any other instruction's span is ``max(span of users) + 1``.  Instructions
sharing a span form a *layer* with no data dependences among them.  The
maximum span is the critical-path length.

Library-call instructions (un-fusable dots — the cuBLAS analogue; on TPU the
XLA-native MXU ``dot_general``) partition the module into segments; fusion
never crosses an LC-layer (§3.2).
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List

from .ir import Instruction, Module


def compute_spans(module: Module) -> Dict[int, int]:
    """span[root] = 0; span[i] = max(span(users)) + 1. Reverse-topo pass."""
    span: Dict[int, int] = {}
    for instr in reversed(module.instructions):
        if not instr.users:
            span[instr.id] = 0
        else:
            span[instr.id] = max(span[u.id] for u in instr.users) + 1
    return span


def layers(module: Module, span: Dict[int, int]) -> Dict[int, List[Instruction]]:
    out: Dict[int, List[Instruction]] = defaultdict(list)
    for instr in module.instructions:
        out[span[instr.id]].append(instr)
    return dict(out)


def critical_path_length(module: Module) -> int:
    span = compute_spans(module)
    return max(span.values()) if span else 0


def work(module: Module) -> int:
    """Total work = number of non-parameter/constant instructions."""
    return sum(
        1 for i in module.instructions if i.opcode not in ("parameter", "constant")
    )


def lc_spans(module: Module, span: Dict[int, int]) -> List[int]:
    """Sorted spans that contain at least one library-call instruction."""
    out = sorted({span[i.id] for i in module.instructions if i.is_library_call})
    return out


def roof_for(root_span: int, lcs: List[int], max_span: int) -> int:
    """The next LC-layer strictly above ``root_span`` (or one past the top).

    Algorithm 1 walks layers in ``(root_span, roof)`` — it never fuses an
    instruction on or above the roof.
    """
    for s in lcs:
        if s > root_span:
            return s
    return max_span + 1


def validate_spans(module: Module, span: Dict[int, int]) -> None:
    """Invariant used by property tests: every operand is strictly deeper
    than each of its users, and same-layer nodes are independent."""
    for instr in module.instructions:
        for op in instr.operands:
            if span[op.id] <= span[instr.id]:
                raise AssertionError(
                    f"span({op.name})={span[op.id]} must exceed "
                    f"span({instr.name})={span[instr.id]}"
                )
