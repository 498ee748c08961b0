"""Carry a reference StitchIR module across into the port.

``module_from_reference`` rebuilds a ``repro.core.ir.Module`` as the port's
``Module`` by duck typing (``.instructions``, ``.opcode``, ``.shape``,
``.dtype``, ``.attrs``, ``.operands``, ``.name``, ``.id``), so this module
imports nothing of the reference.  Every instruction keeps its ``id`` and
``name``: ids feed tie-breaks, ``__hash__`` and the default names, and names
key the outputs, so renumbering would change plans.  Dtype objects in
``attrs`` become numpy dtypes, and the port's id counter moves past the
largest id taken so later instructions never collide.  The reference's
bfloat16 (ml_dtypes', recognised by its name) becomes the port's
``ir.BFLOAT16``, and a bfloat16 array in ``attrs`` a float32 array of the
same values.  Feeds are numpy dicts and pass through unchanged.
"""
from __future__ import annotations

import itertools
from typing import Dict

import numpy as np

from . import ir


def _dtype(d) -> np.dtype:
    d = np.dtype(d)
    return ir.BFLOAT16 if d.name == "bfloat16" else d


def _np_attr(v):
    if isinstance(v, np.ndarray):
        return v.astype(np.float32) if v.dtype.name == "bfloat16" else v
    if isinstance(v, (tuple, list)):
        return type(v)(_np_attr(x) for x in v)
    if isinstance(v, dict):
        return {k: _np_attr(x) for k, x in v.items()}
    if isinstance(v, np.dtype):
        return _dtype(v)
    if isinstance(v, (bool, int, float, str, np.generic)) or v is None:
        return v
    try:  # jnp.float32 and the like: scalar-type objects numpy understands
        return _dtype(v)
    except TypeError:
        return v


def module_from_reference(ref_module) -> ir.Module:
    """The port's copy of a reference module, instruction for instruction."""
    out = ir.Module(ref_module.name)
    by_id: Dict[int, ir.Instruction] = {}
    for r in ref_module.instructions:
        instr = ir.Instruction(
            r.opcode,
            tuple(int(s) for s in r.shape),
            _dtype(r.dtype),
            [by_id[o.id] for o in r.operands],
            {k: _np_attr(v) for k, v in r.attrs.items()},
            name=r.name,
            id=int(r.id),
        )
        by_id[instr.id] = instr
        out.add(instr)
    top = max(by_id, default=-1)
    current = next(ir._uid)
    ir._uid = itertools.count(max(current, top + 1))
    return out
