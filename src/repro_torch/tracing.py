"""The port's tracer: named spans of its compile and replay path, and
integer counters, kept in memory.

    from repro_torch import tracing

    with tracing.span("pass.fusion"):
        ...
    tracing.count("replay.copy_bytes", n)
    spans, counters = tracing.snapshot()

A span records its name, its start and end on ``time.perf_counter_ns``, its
id, the id of the span open around it on the same thread (0 for none), its
call id and its attributes.  The call id is the id of the outermost span
open when it started, so one call's spans share it.  Finished spans go into
a ring of the last ``RING`` spans; counters are integers by name; ``reset``
clears both.

While a ``torch.profiler`` session records, a span also opens a range
``repro_torch.<name>`` on the profiler's host timeline, on the clock the
device's events share, so an idle gap of the device reads what the port
was doing.  The range is an operator's (``_RecordFunctionFast``), not
``record_function``'s user annotation, which the profiler also lays on the
device's timeline, where a reader of device events would count it as a
kernel.  With no session recording, a span costs its two clock reads and
an append.

The spans the port opens, outermost first: ``call`` (a call of a stitched
function), ``compile`` (a plan-cache miss, attributes ``function``,
``arguments``, the call's positional arguments, and, once the plan is
built, ``kernels``, the ``__global__`` symbols of its generated kernels,
``stitch_<hash>_<label>``) with ``capture``, ``lower`` and
``compile_module`` inside, the pipeline's ``pass.<name>`` and ``verify``,
``build`` (``cuda_build.load``: attributes ``nvcc``, whether nvcc ran, and
``source_bytes``), ``execute`` (a run of a
plan, attribute ``mode``: ``graph`` or ``eager``) and ``graph_capture``.
Counters: ``replay.calls``, ``replay.copy_bytes`` (the bytes a replay copies
into the graph's inputs and out of its pool), ``build.nvcc`` and
``build.found`` (translation units compiled, and found built),
``codegen.map_loops`` and ``codegen.map_loops_reordered`` (the element loops
of pure maps emitted, and those of them that walk their output in its own
order because their chunk is not one span of it), ``codegen.cumsums`` (the
running sums emitted, each one thread a row), and ``lower.<op>`` for each
op of ``frontend/aten_lower.py`` ``COUNTED_OPS`` lowered (``lower.slice``,
``lower.convolution``, ``lower.cumsum``, ...).

Not to be confused with ``core/span.py``, the paper's work/span analysis.
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import Dict, Iterable, List, NamedTuple

import torch.autograd.profiler as _profiler
from torch._C._profiler import _RecordFunctionFast as _Range

#: spans the ring keeps, the newest
RING = 1 << 16


class Span(NamedTuple):
    """A finished span; ``parent`` is 0 for an outermost one."""

    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: int
    call: int
    attrs: dict

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


class Snapshot(NamedTuple):
    spans: List[Span]
    counters: Dict[str, int]


class _Open:
    """An open span: the context manager ``Tracer.span`` returns.  Its
    ``attrs`` may be added to until it ends; ``seconds`` reads after."""

    __slots__ = ("tracer", "name", "attrs", "id", "parent", "call", "start_ns", "end_ns",
                 "_stack", "_record")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict):
        self.tracer, self.name, self.attrs = tracer, name, attrs

    def __enter__(self) -> "_Open":
        stack = self._stack = self.tracer._stack()
        self.id = next(self.tracer._ids)
        if stack:
            self.parent, self.call = stack[-1].id, stack[-1].call
        else:
            self.parent, self.call = 0, self.id
        stack.append(self)
        self._record = None
        if _profiler._is_profiler_enabled:
            self._record = _Range("repro_torch." + self.name)
            self._record.__enter__()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.end_ns = time.perf_counter_ns()
        if self._record is not None:
            self._record.__exit__(*exc)
        self._stack.pop()
        # a plain tuple: ``snapshot`` makes the ``Span``s
        self.tracer.spans.append((self.name, self.start_ns, self.end_ns, self.id, self.parent,
                                  self.call, self.attrs))

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


class Tracer:
    """A ring of finished spans and a table of counters, shared by the
    threads of a process; each thread nests its own spans."""

    def __init__(self, ring: int = RING):
        self.spans: deque = deque(maxlen=ring)         # the finished spans' fields
        self.counters: Dict[str, int] = {}
        self._ids = itertools.count(1)
        self._local = threading.local()
        self._lock = threading.Lock()

    def _stack(self) -> List[_Open]:
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def span(self, name: str, **attrs) -> _Open:
        return _Open(self, name, attrs)

    def count(self, name: str, n: int) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def snapshot(self) -> Snapshot:
        with self._lock:
            counters = dict(self.counters)
        return Snapshot([Span._make(s) for s in list(self.spans)], counters)

    def reset(self) -> None:
        self.spans.clear()
        with self._lock:
            self.counters.clear()


def self_seconds(spans: Iterable[Span]) -> Dict[int, float]:
    """Each span's seconds less those of the spans opened directly inside
    it (which run one after another on its thread), by span id."""
    spans = list(spans)
    out = {s.id: s.seconds for s in spans}
    for s in spans:
        if s.parent in out:
            out[s.parent] -= s.seconds
    return out


#: the process's tracer, which the port's spans and counters go to
TRACER = Tracer()
span = TRACER.span
count = TRACER.count
snapshot = TRACER.snapshot
reset = TRACER.reset
