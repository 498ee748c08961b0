"""``BaseEngine`` — the protocol both serve engines satisfy (the
reference's ``repro/serve/base.py``).

``ServeEngine`` (contiguous per-request KV buffers) and ``PagedServeEngine``
(paged KV memory) grew the same driving surface; this protocol pins it
so callers can hold either engine behind one type:

  * ``admit(req) -> bool``     — accept a request if capacity allows
  * ``tick() -> None``         — one scheduler step (prefill and/or decode)
  * ``run_until_done(max_ticks, strict) -> int`` — drive to completion,
    returning the number of ticks consumed
  * ``stats() -> dict``        — engine counters for reporting/benchmarks

``isinstance(engine, BaseEngine)`` works at runtime (structural check).
"""
from __future__ import annotations

from typing import Dict, Protocol, runtime_checkable

from .engine import Request


@runtime_checkable
class BaseEngine(Protocol):
    """Structural type of a serve engine (see module docstring)."""

    def admit(self, req: Request) -> bool:
        ...

    def tick(self) -> None:
        ...

    def run_until_done(self, max_ticks: int = 2000, strict: bool = False) -> int:
        ...

    def stats(self) -> Dict[str, object]:
        ...
