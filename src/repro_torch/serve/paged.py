"""Paged KV memory for the serving layer: the reference's
``repro/serve/paged.py``, copied (pure Python).

The contiguous engine reserves ``max_len`` KV rows per slot up front, so
KV memory — not compute — caps concurrency at ``pool_size``.  Here the KV
cache is a pool of fixed-size blocks (``block_size`` tokens each) handed
out by a free-list :class:`BlockAllocator`; each request owns only the
blocks its actual context occupies, recorded in a logical->physical block
table that the engine's decode step gathers through (``models.init_paged_cache``
/ ``decode_step(block_tables=...)``).

This is the serving-side analogue of the compiler's VMEM planning
(``core/memory.py``): a flat slot table, explicit ALLOC/FREE bookkeeping,
and eager release the moment a value (here: a finished request's context)
is dead.  The allocator is deliberately strict — double-assignment,
double-free and foreign-block frees raise instead of corrupting cache
state that would only surface as wrong tokens much later.
"""
from __future__ import annotations

from typing import Dict, List, Optional


def blocks_for_tokens(num_tokens: int, block_size: int, ring: int) -> int:
    """Blocks needed to hold ``num_tokens`` context tokens in a logical
    ring of ``ring`` token positions (sliding-window reuse caps it)."""
    return -(-min(num_tokens, ring) // block_size)


class BlockAllocator:
    """Fixed-size KV block pool with a LIFO free list.

    Physical ids are ``0 .. num_blocks-1``; the serving engine reserves
    physical index ``num_blocks`` as the parking block (masked writes),
    which is not this allocator's to hand out.
    """

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks <= 0 or block_size <= 0:
            raise ValueError(
                f"need positive num_blocks/block_size, got "
                f"{num_blocks}/{block_size}"
            )
        self.num_blocks = num_blocks
        self.block_size = block_size
        # reversed so .pop() hands out ascending ids first (stable tests)
        self._free: List[int] = list(range(num_blocks - 1, -1, -1))
        self._in_use: set = set()
        self.allocated_total = 0
        self.freed_total = 0
        self.peak_in_use = 0
        self.alloc_failures = 0

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_in_use(self) -> int:
        return len(self._in_use)

    @property
    def utilization(self) -> float:
        return len(self._in_use) / self.num_blocks

    def can_alloc(self, n: int) -> bool:
        return n <= len(self._free)

    def alloc(self, n: int = 1) -> Optional[List[int]]:
        """All-or-nothing: ``n`` blocks or None (counted as a failure —
        the scheduler's cue to preempt)."""
        if n > len(self._free):
            self.alloc_failures += 1
            return None
        blocks = [self._free.pop() for _ in range(n)]
        for b in blocks:
            if b in self._in_use:      # free list corrupt — fail loudly
                raise RuntimeError(f"block {b} double-assigned")
            self._in_use.add(b)
        self.allocated_total += n
        self.peak_in_use = max(self.peak_in_use, len(self._in_use))
        return blocks

    def free(self, blocks: List[int]) -> None:
        for b in blocks:
            if b not in self._in_use:
                raise RuntimeError(
                    f"freeing block {b} that is not allocated "
                    f"(double free or foreign block)"
                )
            self._in_use.remove(b)
            self._free.append(b)
        self.freed_total += len(blocks)

    def check_consistent(self) -> None:
        """Test hook: free list and in-use set must partition the pool."""
        free = set(self._free)
        if len(free) != len(self._free):
            raise RuntimeError("free list contains duplicates")
        if free & self._in_use:
            raise RuntimeError("block both free and in use")
        if free | self._in_use != set(range(self.num_blocks)):
            raise RuntimeError("blocks leaked from the pool")

    def stats(self) -> Dict[str, object]:
        return {
            "num_blocks": self.num_blocks,
            "block_size": self.block_size,
            "in_use": self.num_in_use,
            "free": self.num_free,
            "peak_in_use": self.peak_in_use,
            "peak_utilization": self.peak_in_use / self.num_blocks,
            "allocated_total": self.allocated_total,
            "freed_total": self.freed_total,
            "alloc_failures": self.alloc_failures,
        }
