"""Bytes each replayed call copies: its feeds into the CUDA graph's static
inputs and its roots out of the graph's pool, the port's counters
``replay.copy_bytes`` over ``replay.calls`` (``repro_torch.tracing``)."""
from stitchbench import spans


def read(run):
    snap = spans.snapshot()
    calls = snap.counters.get("replay.calls", 0) if snap is not None else 0
    return snap.counters.get("replay.copy_bytes", 0) / calls if calls else None
