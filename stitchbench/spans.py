"""What the port's tracer (``repro_torch.tracing``) recorded in this
process, for the readers of ``metrics/`` that read it: each returns None
where the port has no tracer or the tracer holds nothing it reads, as in a
checkout older than the tracer."""
from __future__ import annotations

from typing import Callable, Optional

def is_pass(name: str) -> bool:
    """Whether a span is one of the pass pipeline's (``core/pipeline.py``)."""
    return name.startswith("pass.") or name == "verify"


def snapshot():
    """The tracer's spans and counters, or None without a tracer."""
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    return tracing.snapshot()


def seconds(keep: Callable[[object, dict], bool]) -> Optional[float]:
    """The seconds of every span that ``keep(span, spans by id)`` keeps, or
    None where it keeps none."""
    snap = snapshot()
    if snap is None:
        return None
    by_id = {s.id: s for s in snap.spans}
    kept = [s for s in snap.spans if keep(s, by_id)]
    return sum(s.seconds for s in kept) if kept else None


def named(name: str) -> Optional[float]:
    """The seconds of every span called ``name``."""
    return seconds(lambda s, _: s.name == name)


def under_a_pass(span, by_id: dict) -> bool:
    """Whether a pipeline pass's span encloses ``span``."""
    while span.parent in by_id:
        span = by_id[span.parent]
        if is_pass(span.name):
            return True
    return False
