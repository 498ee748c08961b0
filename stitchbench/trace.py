"""Reading the card's activity from ``torch.profiler``.

``device_events`` and ``between_marks`` follow ``chip_smoke.py``'s: a
profiled session runs the measured calls between two long
``torch.cuda._sleep`` marks, with one call and short pads outside each, and
only what started between the marks is read.  On an H100 the profiler has
been seen to lose a session's leading or trailing events, or a whole
session; the pads and the calls outside the marks take such a loss, and a
session that kept other than two marks is taken again.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

PAD_KERNEL = "spin_kernel"
PAD_LAUNCHES = 64
PAD_CYCLES = 1_000
MARK_CYCLES = 200_000
#: a spin kernel that ran this long (about 100 µs for ``MARK_CYCLES``) is a
#: mark, a shorter one (about 1 µs) a pad
MARK_MIN_US = 20.0
#: sessions taken before a run without a whole one fails
PROFILE_TRIES = 4

#: what the library's products run as: cuBLAS and CUTLASS kernel names
#: (cuBLAS runs bfloat16 products on the H100 as ``nvjet_*`` kernels)
GEMM_PATTERNS = ("gemm", "cutlass", "xmma", "splitkreduce", "cublas", "nvjet")
#: what the profiler names a copy or a fill; the replay's batched copy of
#: small feeds is ATen's ``_foreach_copy_`` kernel
COPY_PATTERNS = ("memcpy", "memset", "native::copy<")

Event = Tuple[float, str, float]          # (start µs, name, µs)


def is_gemm(name: str) -> bool:
    n = name.lower()
    return any(p in n for p in GEMM_PATTERNS)


def is_copy(name: str) -> bool:
    n = name.lower()
    return any(p in n for p in COPY_PATTERNS)


def between_marks(device: Sequence[Event]):
    """The device events that started between a session's two marks, from
    its device events (start, name, µs), or None where the profiler kept
    other than two marks; the (end of the first mark, start of the second)
    in µs, or None; and what it kept at the edges: the pads before the
    first mark and after it, and the marks."""
    device = sorted(device)
    spins = [(i, us >= MARK_MIN_US) for i, (_, n, us) in enumerate(device) if PAD_KERNEL in n]
    marks = [i for i, mark in spins if mark]
    lead = sum(1 for i, mark in spins if not mark and (not marks or i < marks[0]))
    edges = {"pads": [lead, sum(1 for _, mark in spins if not mark) - lead], "marks": len(marks)}
    if len(marks) != 2:
        return None, None, edges
    first, second = device[marks[0]], device[marks[1]]
    span = (first[0] + first[2], second[0])
    return list(device[marks[0] + 1:marks[1]]), span, edges


def device_events(call: Callable[[], None], calls: int):
    """One profiled session of ``calls`` calls between two marks.  Returns
    (the device events between the marks, the marks' span, the edges, the
    host events (start µs, name, µs) of the whole session)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(PAD_LAUNCHES):
            torch.cuda._sleep(PAD_CYCLES)
        call()
        torch.cuda._sleep(MARK_CYCLES)
        for _ in range(calls):
            call()
        torch.cuda._sleep(MARK_CYCLES)
        call()
        for _ in range(PAD_LAUNCHES):
            torch.cuda._sleep(PAD_CYCLES)
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    dev, host = [], []
    for e in prof.events():
        row = (e.time_range.start, e.name, e.time_range.elapsed_us())
        (dev if e.device_type == cuda else host).append(row)
    sel, span, edges = between_marks(dev)
    return sel, span, edges, host


def profiled(call: Callable[[], None], calls: int):
    """``device_events`` taken until a session keeps both marks and some
    device event between them, up to ``PROFILE_TRIES`` times.  Returns
    (events, span, host events, the refused sessions' edges)."""
    refused = []
    for _ in range(PROFILE_TRIES):
        sel, span, edges, host = device_events(call, calls)
        if sel:
            return sel, span, host, refused
        refused.append(edges)
    raise RuntimeError(f"no profile in {PROFILE_TRIES} kept both marks and a device event: {refused}")


def busy_us(events: Sequence[Event], span: Tuple[float, float]) -> float:
    """Microseconds inside ``span`` in which some device event ran."""
    lo, hi = span
    total, cur_s, cur_e = 0.0, None, None
    for s, _, us in sorted(events):
        s, e = max(s, lo), min(s + us, hi)
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_gaps(events: Sequence[Event], span: Tuple[float, float]) -> List[Tuple[float, float]]:
    """The (start µs, µs) of each stretch of ``span`` with no device event."""
    gaps, at = [], span[0]
    for s, _, us in sorted(events):
        if s > at:
            gaps.append((at, s - at))
        at = max(at, s + us)
    if span[1] > at:
        gaps.append((at, span[1] - at))
    return gaps


def host_activity(host: Sequence[Event], at: float) -> str:
    """The innermost host event running at ``at`` µs, or "host idle"."""
    best: Optional[Event] = None
    for s, name, us in host:
        if s <= at < s + us and (best is None or us < best[2]):
            best = (s, name, us)
    return best[1] if best else "host idle"


def top(pairs, n: int = 10) -> List[List]:
    """The ``n`` names of most seconds, summed over ``pairs`` of (name, µs),
    as [name, seconds]."""
    total = {}
    for name, us in pairs:
        total[name] = total.get(name, 0.0) + us
    ranked = sorted(total.items(), key=lambda kv: -kv[1])[:n]
    return [[name, us / 1e6] for name, us in ranked]
