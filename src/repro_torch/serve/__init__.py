"""Serving: the slot-ring and paged engines, the block allocator, the
scheduler and the traffic harness — the reference's ``repro.serve`` over
``repro_torch.models``.  Engines run on the card unless the caller asks for
the CPU, and on the card replay each step from a CUDA graph."""
from .base import BaseEngine
from .engine import (
    PagedServeEngine,
    Request,
    ServeEngine,
    decode_cache_size,
    decode_cache_stats,
)
from .paged import BlockAllocator, blocks_for_tokens
from .scheduler import Scheduler, SLOConfig
from .traffic import TraceConfig, TraceEntry, TrafficReport, generate_trace, run_trace
