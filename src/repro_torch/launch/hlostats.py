"""Collective statistics: the census of collectives by kind, with each
loop's collectives counted once per trip — the reference's
``repro/launch/hlostats.py`` over what torch gives in place of optimized
HLO.

The reference parses XLA's HLO text: computations, each while's trip count
from its condition, and every collective's result bytes scaled by the trip
counts around it.  The port has two sources, both read by
``collective_bytes``:

  * a traced ``torch.fx.GraphModule`` (``make_fx``): every ``c10d.*`` and
    ``_c10d_functional.*`` node, sized by its result (``meta["val"]``), and
    each ``higher_order.scan`` body counted once per trip (the length of its
    xs); a ``while_loop`` body once, as the reference's cost model counts a
    while body;
  * the run of a function under ``launch.costmodel.CountingMode`` (the
    dry run's form): the collectives as they dispatched, so a Python loop
    is already counted once per trip.

Bytes are RESULT bytes, as in the reference: an all-gather counts the
gathered tensor, a reduce-scatter the block it keeps.  Nothing runs in a
dry run, so nothing here reads a profile.
"""
from __future__ import annotations

from typing import Dict, Iterable, Tuple

import torch

from .costmodel import COLLECTIVE_KINDS, CountingMode, nbytes

_COLL_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")


def _result_bytes(val) -> int:
    if isinstance(val, torch.Tensor):
        return nbytes(val)
    if isinstance(val, (list, tuple)):
        return sum(_result_bytes(v) for v in val)
    return 0


def _target_name(target) -> str:
    packet = getattr(target, "overloadpacket", None)
    if packet is not None:
        return packet.__name__
    return getattr(target, "__name__", str(target))


def graph_collectives(gm: torch.fx.GraphModule) -> Dict[str, float]:
    """The census of a traced graph (module docstring)."""
    out: Dict[str, float] = {}

    def add(kind, n, times=1):
        out[kind] = out.get(kind, 0.0) + float(n) * times

    for node in gm.graph.nodes:
        if node.op != "call_function":
            continue
        name = _target_name(node.target)
        if name in COLLECTIVE_KINDS:
            add(COLLECTIVE_KINDS[name], _result_bytes(node.meta.get("val")))
        elif name in ("scan", "while_loop"):
            body = getattr(gm, node.args[0 if name == "scan" else 1].target)
            trips = 1
            if name == "scan":
                xs = node.args[2]
                trips = int(xs[0].meta["val"].shape[0]) if xs else 1
            for kind, n in graph_collectives(body).items():
                add(kind, n, trips)
    return out


def tally_collectives(calls: Iterable[Tuple[str, int]]) -> Dict[str, float]:
    """The census of (kind, result bytes) calls, one entry a call."""
    out: Dict[str, float] = {}
    for kind, n in calls:
        out[kind] = out.get(kind, 0.0) + float(n)
    return out


def collective_bytes(source) -> Dict[str, float]:
    """{kind: bytes} of a ``GraphModule``, a ``CountingMode`` that ran a
    function, or a list of (kind, bytes) calls."""
    if isinstance(source, torch.fx.GraphModule):
        return graph_collectives(source)
    if isinstance(source, CountingMode):
        return tally_collectives(source.collectives)
    return tally_collectives(source)
